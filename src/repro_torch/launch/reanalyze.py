"""Re-run the roofline analysis over saved count tables (no model run).

The port's counterpart of the reference package's
``launch/reanalyze.py``: each ``ok`` record of a dry run is brought up to
date from the per-op count table ``launch.dryrun`` saved beside it
(``counts/<mesh>__<arch>__<shape>[__tag].json.gz``, in place of the
reference's HLO), by ``roofline.analyze`` at the current peaks.

  python -m repro_torch.launch.reanalyze [artifacts/dryrun_torch]
"""
import glob
import json
import os
import sys

from repro_torch.launch import hlo_cost as HC
from repro_torch.launch import roofline as RL


def main(out_dir="artifacts/dryrun_torch"):
    for jpath in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(jpath) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        tag = rec.get("tag", "")
        sfx = f"__{tag}" if tag else ""
        tpath = os.path.join(out_dir, "counts", f"{rec['mesh']}__"
                             f"{rec['arch']}__{rec['shape']}{sfx}.json.gz")
        if not os.path.exists(tpath):
            continue
        rec.update(RL.analyze(HC.load_table(tpath), chips=rec["chips"],
                              model_flops=rec.get("model_flops"),
                              memory=rec.get("memory")))
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        print(f"reanalyzed {os.path.basename(jpath)}: "
              f"dominant={rec['dominant']}")


if __name__ == "__main__":
    main(*sys.argv[1:])
