"""Mamba-2 SSD (state-space duality) block.

Counterpart of the reference package's ``models/mamba2.py`` (plain array
code there too: no Pallas).  Chunked SSD (Dao & Gu, arXiv:2405.21060
§6): the sequence is split into chunks of Q tokens; within a chunk the
output is a masked quadratic (attention-like) term, across chunks a
low-rank recurrence on the (H, P, N) state runs as a Python loop over
the chunks, the state in f32.  ``ssd_naive`` is the O(S) sequential
oracle; decode is one state update a token.

Shapes: x (B, S, H, P) heads; A (H,) log decay; B/C (B, S, N) (one
group); dt (B, S, H) softplus-positive step sizes.

``Mamba2Mixer`` holds ``in_proj`` and ``out_proj`` in bf16 like every
matmul weight of the port, and ``conv_w``, ``A_log``, ``D``, ``dt_bias``
and ``norm`` in f32: the reference keeps those five in f32 and uses them
uncast, so ``conv_w`` multiplies the bf16 ``xBC`` in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import CDTYPE, _weight, dense_init, rms_norm, silu


def _dims(cfg):
    """(d_inner, H, N) of ``cfg``'s mixer."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return d_inner, d_inner // sc.head_dim, sc.d_state


class Mamba2Mixer(torch.nn.Module):
    """``in_proj`` (d, 2 d_inner + 2 N + H) and ``out_proj`` (d_inner, d)
    bf16; ``conv_w`` (d_conv, d_inner + 2 N) ``N(0, 1) * 0.2``, ``A_log``
    ``log(linspace(1, 16, H))``, ``D`` ones, ``dt_bias`` zeros and the
    gain ``norm`` (d_inner,) ones, all f32.  ``gen=None`` allocates the
    random ones uninitialised."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        sc = cfg.ssm
        d = cfg.d_model
        d_inner, H, N = _dims(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        self.in_proj = _weight(dense_init(gen, d, 2 * d_inner + 2 * N + H,
                                          device=device))
        shape = (sc.d_conv, d_inner + 2 * N)
        self.conv_w = _weight(
            torch.empty(shape, **f32) if gen is None
            else torch.randn(shape, generator=gen, **f32) * 0.2)
        self.A_log = _weight(torch.log(torch.linspace(1.0, 16.0, H, **f32)))
        self.D = _weight(torch.ones(H, **f32))
        self.dt_bias = _weight(torch.zeros(H, **f32))
        self.norm = _weight(torch.ones(d_inner, **f32))
        self.out_proj = _weight(dense_init(gen, d_inner, d, device=device))


def _causal_conv(xbc, conv_w, conv_state=None):
    """Depthwise causal conv over (B, S, C); optional carried state
    (B, d_conv - 1, C) for decode.  Returns (silu(out), new_state): the
    taps summed in the order 0..k-1 in the product's dtype (f32 with the
    f32 ``conv_w`` of serving, bf16 with the train step's cast), the new
    state the last k - 1 inputs in ``xbc``'s dtype."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], 1)
    S = xbc.shape[1]
    out = full[:, 0:S] * conv_w[0]
    for i in range(1, k):
        out = out + full[:, i:i + S] * conv_w[i]
    # bf16 taps (the train step's cast of conv_w): the reference's silu
    # rounds at each of its ops, so run it op by op (layers.silu); in f32
    # the fused form is the same to an ulp and keeps serving's peak
    act = silu if out.dtype == CDTYPE else F.silu
    return act(out), full[:, -(k - 1):]


def _records(t) -> bool:
    """Whether autograd records an op on ``t``: then no in-place op may
    overwrite an output that a backward needs."""
    return torch.is_grad_enabled() and t.requires_grad


def _intra_decay(seg):
    """exp(seg_q - seg_k) for q >= k, else 0, as (B, nc, Q, Q, H) from the
    within-chunk cumsum ``seg`` (B, nc, Q, H).  The q < k entries are set
    to -1e9 BEFORE the exp: they are positive and would overflow to inf,
    and a mask applied after it would meet inf (0 * inf = NaN).  The exp
    is in place unless autograd records it (its backward needs its
    output)."""
    Q = seg.shape[2]
    gamma = seg[:, :, :, None, :] - seg[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=seg.device).tril()
    gamma.masked_fill_(~causal[:, :, None], -1e9)
    return gamma.exp() if _records(gamma) else gamma.exp_()


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """Chunked SSD scan.  x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N),
    all f32.  Returns (y (B,S,H,P), final_state (B,H,P,N) f32).

    Each product of three operands is split into an elementwise product
    and one two-operand contraction, so no (B, nc, Q, Q, H, P) tensor is
    formed: the largest is the (B, nc, Q, Q, H) decay."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"the sequence ({S}) is not a multiple of the "
                         f"chunk ({Q})")
    nc = S // Q
    xd = (x * dt[..., None]).reshape(Bsz, nc, Q, H, Pd)     # dt-weighted input
    dA = (dt * (-torch.exp(A))).reshape(Bsz, nc, Q, H)      # <= 0
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    seg = torch.cumsum(dA, dim=2)                            # within-chunk
    total = seg[:, :, -1, :]                                 # (B,nc,H)

    # ---- intra-chunk (quadratic) term ------------------------------------
    gamma = _intra_decay(seg)                                # (B,nc,Q,Q,H)
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)[..., None]
    # in place for serving, whose peak is this tensor (the prefill_32k
    # arm); cb dropped before the next product for the same reason
    gamma = gamma * cb if _records(gamma) or _records(cb) \
        else gamma.mul_(cb)
    del cb
    y = torch.einsum("bcqkh,bckhp->bcqhp", gamma, xd)
    del gamma

    # ---- chunk states + inter-chunk recurrence ---------------------------
    # state_c = sum_k exp(total - seg_k) B_k x_k   (chunk c's contribution)
    w = torch.exp(total[:, :, None, :] - seg)                # (B,nc,Q,H)
    st = torch.einsum("bcqhp,bcqn->bchpn", w[..., None] * xd, Bc)
    h = (x.new_zeros((Bsz, H, Pd, N), dtype=torch.float32)
         if init_state is None else init_state.to(torch.float32))
    decay = torch.exp(total)
    h_prev = []                                              # before chunk c
    for c in range(nc):
        h_prev.append(h)
        h = h * decay[:, c, :, None, None] + st[:, c]
    h_prev = torch.stack(h_prev, 1)                          # (B,nc,H,P,N)

    # ---- inter-chunk term: y += C_q exp(seg_q) h_prev ---------------------
    y += torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) \
        * torch.exp(seg)[..., None]
    return y.reshape(Bsz, S, H, Pd).to(x.dtype), h


def ssd_naive(x, dt, A, Bm, Cm, *, init_state=None):
    """Sequential O(S) oracle: h_t = h_{t-1} e^{dt_t A} + dt_t B_t x_t."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    h = (x.new_zeros((Bsz, H, Pd, N), dtype=torch.float32)
         if init_state is None else init_state.to(torch.float32))
    negA = -torch.exp(A)
    ys = []
    for t in range(S):
        dtt = dt[:, t]
        decay = torch.exp(dtt * negA)[:, :, None, None]      # (B,H,1,1)
        h = h * decay + (dtt[..., None] * x[:, t])[..., None] \
            * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h


def _project(params, cfg, u):
    """in_proj of u (bf16) split into z, xBC, dt_raw."""
    d_inner, _, N = _dims(cfg)
    proj = u.to(CDTYPE) @ params.in_proj
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * N],
            proj[..., 2 * d_inner + 2 * N:])


def _gate_out(params, u, y, z):
    """rms_norm(y, norm) * silu(z) in f32, then out_proj in bf16."""
    y = rms_norm(y, params.norm) * F.silu(z.to(torch.float32))
    return (y.to(CDTYPE) @ params.out_proj).to(u.dtype)


def mamba_forward(params, cfg, u, *, init_state=None, conv_state=None,
                  return_state=False):
    """Full-sequence forward.  u (B, S, D).  With ``return_state``, also
    (h (B,H,P,N) f32, conv (B, d_conv - 1, C) bf16)."""
    sc = cfg.ssm
    d_inner, H, N = _dims(cfg)
    B_, S, _ = u.shape
    z, xBC, dt_raw = _project(params, cfg, u)
    xBC, new_conv = _causal_conv(xBC, params.conv_w, conv_state)
    xs = xBC[..., :d_inner].reshape(B_, S, H, sc.head_dim)
    Bm = xBC[..., d_inner:d_inner + N].to(torch.float32)
    Cm = xBC[..., d_inner + N:].to(torch.float32)
    # F.softplus is the identity above 20, where jax.nn.softplus adds
    # log1p(exp(-x)) < 2.1e-9: below f32's resolution there (an ulp at 20
    # is 1.9e-6), so the two agree in f32
    dt = F.softplus(dt_raw.to(torch.float32) + params.dt_bias)
    y, h = ssd_chunked(xs.to(torch.float32), dt, params.A_log, Bm, Cm,
                       chunk=sc.chunk, init_state=init_state)
    y = y + params.D[:, None] * xs.to(torch.float32)
    out = _gate_out(params, u, y.reshape(B_, S, d_inner), z)
    return (out, (h, new_conv)) if return_state else out


def mamba_decode(params, cfg, u, state):
    """One-token decode.  u (B, 1, D); state = (h (B,H,P,N) f32,
    conv (B, d_conv - 1, C)).  Returns (out, (h, conv)), both new."""
    sc = cfg.ssm
    d_inner, H, N = _dims(cfg)
    h, conv_state = state
    B_ = u.shape[0]
    z, xBC, dt_raw = _project(params, cfg, u)
    xBC, new_conv = _causal_conv(xBC, params.conv_w, conv_state)
    xs = xBC[..., :d_inner].reshape(B_, H, sc.head_dim).to(torch.float32)
    Bm = xBC[:, 0, d_inner:d_inner + N].to(torch.float32)
    Cm = xBC[:, 0, d_inner + N:].to(torch.float32)
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + params.dt_bias)
    decay = torch.exp(dt * (-torch.exp(params.A_log)))[:, :, None, None]
    h = h * decay + (dt[..., None] * xs)[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm) + params.D[:, None] * xs
    return _gate_out(params, u, y.reshape(B_, 1, d_inner), z), (h, new_conv)


def init_mamba_state(cfg, batch, dtype=torch.float32, *, device=None):
    """Zero (h (B,H,P,N) f32, conv (B, d_conv - 1, d_inner + 2 N) dtype)."""
    sc = cfg.ssm
    d_inner, H, N = _dims(cfg)
    return (torch.zeros((batch, H, sc.head_dim, N), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, sc.d_conv - 1, d_inner + 2 * N), dtype=dtype,
                        device=device))
