"""The train step: mixed precision and microbatching.

Counterpart of the reference package's ``train/train_step.py``:

  * the state holds f32 master weights; each step casts EVERY master to
    bf16 (the norm gains, the MoE router and the Mamba-2 mixer's
    ``A_log``, ``D``, ``dt_bias`` and ``conv_w`` too, as the reference's
    ``astype`` of every f32 leaf does), runs the loss on that cast and
    takes bf16 grads;
  * with microbatches, the grads are summed in bf16 and divided by the
    count in bf16, the loss averaged in f32, and the metrics are the last
    microbatch's;
  * AdamW then updates the f32 masters.

The loss runs on one module of the model's family (``api.init(None)``)
whose parameters are bf16 leaves that require grad, built at the first
step and refilled from the masters at each; remat is the model's
(``build_model(..., remat=...)``).  The step is functional: it returns
a new ``TrainState``.

On a mesh (``api.mesh``) the masters and both moments are ``DTensor``s
in the parameters' placements, and AdamW runs on each rank's shards.
The loss's module holds the masters' bf16 casts gathered whole; each
rank runs the global loss's term of its rows (``models.lm``), so a
weight's gradient is the sum of the ranks' over the DP dims only (the
ranks along ``"model"`` hold the same rows and the same gradient), of
which a rank keeps its shard.  The global norm sums every rank's
shards once (a shard held by r ranks counts 1/r on each).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import layers as L
from repro_torch.models import placement as P
from repro_torch.train.optimizer import adamw_init, adamw_update


@dataclass
class TrainState:
    """``params``: {name: f32 master} in the module's parameter order
    (``DTensor``s on a mesh); ``opt``: ``adamw_init``'s state; ``step``:
    an int32 0-d tensor."""
    params: dict
    opt: dict
    step: torch.Tensor


def init_state(api, generator, *, moment_dtype=torch.float32) -> TrainState:
    """Masters drawn on ``generator`` by the model's own init, kept f32
    (``layers.master_init``): rounded to bf16 they are the serving
    init's weights from the same generator."""
    with L.master_init():
        model = api.init(generator)
    params = {name: p.detach() for name, p in model.named_parameters()}
    step = torch.zeros((), dtype=torch.int32,
                       device=P.local(next(iter(params.values()))).device)
    return TrainState(params, adamw_init(params, moment_dtype=moment_dtype),
                      step)


def lr_schedule(step, *, peak=3e-4, warmup=100, total=10_000):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine to
    0 at ``total``; f32, as the reference's."""
    step = torch.as_tensor(step)
    warm = peak * (step + 1) / warmup
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * 0.5 * (1.0 + torch.cos(torch.pi * frac))
    return torch.where(step < warmup, warm, cos)


def _split(batch: dict, microbatches: int) -> list:
    """The batch's rows in ``microbatches`` equal consecutive parts."""
    B = len(next(iter(batch.values())))
    if B % microbatches:
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{microbatches} microbatches")
    mb = B // microbatches
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(microbatches)]


def state_shardings(state: TrainState) -> TrainState:
    """The ``checkpoint.restore(shardings=)`` tree of ``state``: each
    placed master's and moment's placement (``configs.sharding.Placed``),
    None for the step counts, or None without a mesh."""
    from repro_torch.configs.sharding import Placed
    first = next(iter(state.params.values()))
    if not P.is_placed(first):
        return None

    def tree(d):
        return {n: Placed(t.device_mesh, P.spec_of(t)) for n, t in d.items()}
    return TrainState(tree(state.params),
                      {"m": tree(state.opt["m"]), "v": tree(state.opt["v"]),
                       "step": None}, None)


def _mesh_grads(grads: list, masters: list, mesh, dp_axes, split: bool):
    """Each rank's whole-weight grads summed over the DP ranks (when they
    split the batch), then cut to this rank's shard of its master."""
    out = []
    for g, m in zip(grads, masters):
        dtype = g.dtype
        if split:
            g = P.all_reduce(g.to(torch.float32), mesh, dp_axes)
        out.append(P.local_part(g, mesh, P.spec_of(m)).to(dtype))
    return out


def _sq_norm(masters: dict, mesh):
    """The squared global norm of shards placed as ``masters``."""
    def sq(grads):
        local = sum(torch.sum(torch.square(g.to(torch.float32)))
                    / P.replication(masters[n]) for n, g in grads.items())
        return P.all_reduce(local, mesh, P.mesh_names(mesh))
    return sq


def make_train_step(api, *, microbatches: int = 1,
                    grad_dtype=torch.bfloat16, lr_fn: Callable = lr_schedule,
                    weight_decay: float = 0.1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the
    metrics are the loss's (``ce`` ...) plus ``loss``, ``gnorm`` and
    ``lr``, detached 0-d tensors on the model's device."""
    if grad_dtype != torch.bfloat16:
        raise ValueError("the port's forward holds its weights in bf16: "
                         f"grad_dtype must be torch.bfloat16, not "
                         f"{grad_dtype}")
    work: dict = {}
    mesh = api.mesh

    def half_params(state):
        """The loss's module, its parameters the masters' bf16 cast
        (gathered whole on a mesh)."""
        if not work:
            model = api.init(None)
            for name, p in list(model.named_parameters()):
                mod_name, _, leaf = name.rpartition(".")
                mod = model.get_submodule(mod_name) if mod_name else model
                mod._parameters[leaf] = torch.nn.Parameter(torch.empty(
                    p.shape, dtype=grad_dtype, device=P.local(p).device))
            work["model"] = model
            work["named"] = dict(model.named_parameters())
        with torch.no_grad():
            for name, p in work["named"].items():
                p.copy_(P.full(state.params[name], dtype=grad_dtype))
        return work["model"], list(work["named"].values())

    def grads_of(model, plist, batch):
        loss, metrics = api.loss(model, batch)
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), metrics, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(plist, grads)]

    def _mesh_update(state, grads, batch, lr):
        """AdamW on each rank's shards, from the ranks' summed grads."""
        names = list(work["named"])
        rows = len(next(iter(batch.values()))) // microbatches
        split = P.Rows(mesh, api.dp_axes, rows).split
        masters = [state.params[n] for n in names]
        local_g = dict(zip(names, _mesh_grads(grads, masters, mesh,
                                              api.dp_axes, split)))
        loc = {n: P.local(state.params[n]) for n in names}
        opt = {"m": {n: P.local(v) for n, v in state.opt["m"].items()},
               "v": {n: P.local(v) for n, v in state.opt["v"].items()},
               "step": state.opt["step"]}
        new_p, new_o, gnorm = adamw_update(
            loc, local_g, opt, lr=lr, weight_decay=weight_decay,
            sq_norm=_sq_norm(state.params, mesh))
        return ({n: P.like(state.params[n], t) for n, t in new_p.items()},
                {"m": {n: P.like(state.opt["m"][n], t)
                       for n, t in new_o["m"].items()},
                 "v": {n: P.like(state.opt["v"][n], t)
                       for n, t in new_o["v"].items()},
                 "step": new_o["step"]}, gnorm)

    def train_step(state: TrainState, batch):
        model, plist = half_params(state)
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, plist, batch)
        else:
            loss, grads = 0.0, None
            for mbatch in _split(batch, microbatches):
                l, metrics, g = grads_of(model, plist, mbatch)
                grads = g if grads is None else [
                    a + b for a, b in zip(grads, g)]
                loss = loss + l
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        lr = lr_fn(state.step)
        if mesh is None:
            new_params, new_opt, gnorm = adamw_update(
                state.params, dict(zip(work["named"], grads)), state.opt,
                lr=lr, weight_decay=weight_decay)
        else:
            new_params, new_opt, gnorm = _mesh_update(state, grads, batch,
                                                      lr)
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        metrics.update(loss=loss, gnorm=gnorm, lr=torch.as_tensor(lr))
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
