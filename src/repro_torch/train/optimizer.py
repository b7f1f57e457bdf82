"""AdamW with decoupled weight decay over a dict of tensors.

Counterpart of the reference package's ``train/optimizer.py``.  The
state is ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32
0-d}``; the moments are f32 by default, bf16 when asked (half the
optimizer memory).  The update is functional: it returns new tensors.
Placed parameters (``DTensor``s on a mesh) get moments placed alike.
"""
from __future__ import annotations

import torch

from repro_torch.models import placement as P


def adamw_init(params: dict, *, moment_dtype=torch.float32) -> dict:
    """Zero moments of ``moment_dtype`` beside each parameter, placed as
    it is."""
    def zeros():
        return {name: P.like(p, torch.zeros(P.local(p).shape,
                                            dtype=moment_dtype,
                                            device=P.local(p).device))
                for name, p in params.items()}
    device = P.local(next(iter(params.values()))).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params: dict, grads: dict, opt: dict, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
                 sq_norm=None):
    """One AdamW step of ``params`` (f32 masters) by ``grads`` (any float
    dtype, one per parameter: a parameter the loss does not reach has a
    zero grad and still decays): the global norm of the grads summed in
    f32, the grads scaled to a norm of at most ``grad_clip``, bias-
    corrected moments, decay ``weight_decay`` on every parameter.
    Returns (new params, new opt, the unclipped global norm).
    ``sq_norm(grads)``, if given, gives the squared global norm (a mesh's
    sum over every rank's shards)."""
    step = opt["step"] + 1
    gsq = sq_norm(grads) if sq_norm is not None else sum(
        torch.sum(torch.square(g.to(torch.float32))) for g in grads.values())
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        m, v = opt["m"][name], opt["v"][name]
        g32 = grads[name].to(torch.float32) * scale
        m_new = b1 * m.to(torch.float32) + (1 - b1) * g32
        v_new = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        mhat, vhat = m_new / bc1, v_new / bc2
        new_p[name] = p - lr * (mhat / (torch.sqrt(vhat) + eps)
                                + weight_decay * p)
        new_m[name], new_v[name] = m_new.to(m.dtype), v_new.to(v.dtype)
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
