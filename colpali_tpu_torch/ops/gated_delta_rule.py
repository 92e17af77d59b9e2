"""The chunked gated delta rule: kernel Q2.

Counterpart of :func:`colpali_tpu.models.qwen3_5.chunk_gated_delta_rule`
(HF ``torch_chunk_gated_delta_rule``, modeling_qwen3_next.py:440-517), the
token mixer of Qwen3.5's GatedDeltaNet layers. From ``query, key (B, S, Hk,
Dk)``, ``value (B, S, Hv, Dv)``, the log-decay ``g (B, S, Hv)`` (fp32, as
the JAX package computes it) and ``beta (B, S, Hv)``, with value head ``j``
reading key head ``j // (Hv / Hk)`` (JAX's ``jnp.repeat`` over the heads),
it returns ``(B, S, Hv, Dv)`` in the query's dtype. Everything runs in fp32:
q and k are l2-normalised (eps 1e-6) and q scaled by ``Dk**-0.5``, the
sequence is cut into chunks of 64 (rows past ``S`` are zero rows with ``g =
beta = 0``), and a ``(Dk, Dv)`` state per head is carried from chunk to
chunk. In a chunk with in-chunk cumulative decay ``G``:

- ``T = -(beta k k^T) * exp(G_i - G_j)`` on the strict lower triangle, the
  exponent masked before ``exp`` (the upper triangle's ``G_i - G_j`` is
  positive and overflows);
- ``v_new = (I - T)^-1 (beta v - beta e^G (k S))``;
- ``out = e^G (q S) + tril(q k^T * exp(G_i - G_j)) v_new``;
- ``S <- e^{G_last} S + (k e^{G_last - G})^T v_new``.

:func:`chunk_gated_delta_rule` launches ``csrc/gated_delta_rule.cu`` for
CUDA tensors (Dk = 128, Dv a multiple of 64; q/k/v may be strided views of
the conv's output: no transpose, pad or head repeat in device memory) and
runs :func:`chunk_gated_delta_rule_plain`, JAX's algorithm op for op, for
CPU tensors. On the card a call whose inputs need a gradient goes through
:class:`GatedDeltaRule`, a ``torch.autograd.Function``: its forward launches
the same kernel, which also writes the fp32 state at every chunk's start,
and its backward launches ``csrc/gated_delta_rule_bwd.cu`` (the reverse scan
over the chunks, then a fixed-order sum over the value heads of a key head
and the l2norm's backward). :func:`chunk_gated_delta_rule_backward_plain` is
that backward's algorithm as a reverse scan in plain PyTorch, what the
kernel is held to on the card. On the CPU autograd differentiates the plain
forward, as JAX differentiates its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from colpali_tpu_torch.ops._cuda import I32, I64, P, CudaKernel, check_cuda, on_cpu

GATED_DELTA_RULE = CudaKernel("colpali_gated_delta_rule", [*[P] * 7, *[I32] * 6, I64, I64])
GATED_DELTA_RULE_BWD = CudaKernel("colpali_gated_delta_rule_bwd", [*[P] * 13, *[I32] * 6, I64, I64])
CHUNK = 64
KEY_DIMS = (128,)  # the kernel's Dk; Dv a multiple of VALUE_BLOCK
VALUE_BLOCK = 64  # state columns a CTA holds


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FLA-style l2norm (modeling_qwen3_next.py:436-439): ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _check_shapes(query, key, value, g, beta) -> None:
    b, s, hk, dk = query.shape
    if key.shape != query.shape:
        raise ValueError(f"key {tuple(key.shape)} != query {tuple(query.shape)}")
    if value.ndim != 4 or value.shape[:2] != (b, s) or value.shape[2] % hk:
        raise ValueError(f"value {tuple(value.shape)} must be (B={b}, S={s}, Hv, Dv) with Hv a multiple of {hk}")
    hv = value.shape[2]
    for name, t in (("g", g), ("beta", beta)):
        if tuple(t.shape) != (b, s, hv):
            raise ValueError(f"{name} {tuple(t.shape)} != {(b, s, hv)}")


def chunk_gated_delta_rule_plain(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, g: torch.Tensor,
                                 beta: torch.Tensor, chunk_size: int = CHUNK) -> torch.Tensor:
    """Q2's plain version: the JAX package's ``chunk_gated_delta_rule`` op
    for op (key heads repeated to the value heads, the triangular solve, the
    scan over chunks as a loop), in fp32, differentiable."""
    _check_shapes(query, key, value, g, beta)
    in_dtype = query.dtype
    b, s, hk, dk = query.shape
    h, dv = value.shape[2], value.shape[3]
    rep = h // hk
    q = l2norm(query.float())
    k = l2norm(key.float())
    if rep > 1:
        q, k = q.repeat_interleave(rep, dim=2), k.repeat_interleave(rep, dim=2)
    q, k, v = (x.transpose(1, 2) for x in (q, k, value.float()))  # (B, H, S, D)
    g, beta = g.float().transpose(1, 2), beta.float().transpose(1, 2)
    pad = (-s) % chunk_size
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        g, beta = F.pad(g, (0, pad)), F.pad(beta, (0, pad))
    total = s + pad
    n, c = total // chunk_size, chunk_size
    q = q * dk**-0.5
    v_beta = v * beta[..., None]
    k_beta = k * beta[..., None]
    q, k, v, k_beta, v_beta = (x.reshape(b, h, n, c, x.shape[-1]) for x in (q, k, v, k_beta, v_beta))
    g = torch.cumsum(g.reshape(b, h, n, c), dim=-1)
    idx = torch.arange(c, device=q.device)
    lower_incl = idx[None, :] <= idx[:, None]
    strict_lower = idx[None, :] < idx[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    def decay_of(gc):  # the exponent masked before exp (see the module docstring)
        diff = torch.where(lower_incl, gc[..., :, None] - gc[..., None, :], zero)
        return torch.where(lower_incl, torch.exp(diff), zero)

    t_mat = torch.where(strict_lower, -(k_beta @ k.transpose(-1, -2)) * decay_of(g), zero)
    eye = torch.eye(c, dtype=torch.float32, device=q.device)
    attn = torch.linalg.solve_triangular(eye - t_mat, eye.expand(t_mat.shape), upper=False)
    v2 = attn @ v_beta
    k_cumdecay = attn @ (k_beta * torch.exp(g)[..., None])
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    outs = []
    for i in range(n):
        q_i, k_i, g_i = q[:, :, i], k[:, :, i], g[:, :, i]
        attn_local = torch.where(lower_incl, (q_i @ k_i.transpose(-1, -2)) * decay_of(g_i), zero)
        v_new = v2[:, :, i] - k_cumdecay[:, :, i] @ state
        outs.append((q_i * torch.exp(g_i)[..., None]) @ state + attn_local @ v_new)
        g_last = g_i[..., -1]
        state = state * torch.exp(g_last)[..., None, None] + (
            k_i * torch.exp(g_last[..., None] - g_i)[..., None]).transpose(-1, -2) @ v_new
    out = torch.stack(outs, dim=2).reshape(b, h, total, dv)[:, :, :s]
    return out.transpose(1, 2).to(in_dtype)


def chunk_gated_delta_rule_backward_plain(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                                          g: torch.Tensor, beta: torch.Tensor, d_out: torch.Tensor) -> tuple:
    """Q2's backward as an explicit reverse scan (``csrc/gated_delta_rule_bwd.cu``'s
    algorithm, not autograd): ``(dq, dk, dv, dg, dbeta)`` of the forward's
    output against ``d_out``, in fp32, taken with respect to the inputs as the
    forward takes them (q and k before the l2norm and the scale; ``dq`` and
    ``dk`` summed over the value heads that read each key head). A forward
    scan keeps the state at each chunk's start and each chunk's ``Vnew``;
    the reverse scan carries ``dS (Dk, Dv)`` and, in a chunk (``M = I - T``,
    ``Gam`` the masked decay, ``E = dP o P + dT o T``):

    - ``dVn = Kd dS' + P^T dO`` with ``Kd = e^{G_L - G} k``, ``dU = M^-T dVn``
      (a triangular solve against the transpose: the inverse is never formed);
    - ``dv = beta dU``, ``dP = tril(dO Vn^T)``, ``dT = strict_tril(dU Vn^T)``;
    - ``dq^ = e^G dO S^T + (dP o Gam) k``, ``dk^ = Kd-side and S-side terms
      + (dP o Gam)^T q + (dK + dK^T) k`` with ``dK = -beta (dT o Gam)``;
    - ``dG`` from every exponent (``e^G``, ``Gam``, ``e^{G_L - G}``,
      ``e^{G_L}``), ``dg`` its reverse cumulative sum in the chunk;
    - ``dS = e^{G_L} dS' + q^T (e^G dO) + k^T dKS``."""
    _check_shapes(query, key, value, g, beta)
    b, s, hk, dk = query.shape
    h, dv = value.shape[2], value.shape[3]
    rep = h // hk
    if tuple(d_out.shape) != (b, s, h, dv):
        raise ValueError(f"d_out {tuple(d_out.shape)} != {(b, s, h, dv)}")
    scale = dk**-0.5
    qx, kx = query.float(), key.float()
    qn, kn = l2norm(qx), l2norm(kx)
    pad = (-s) % CHUNK
    n, c = (s + pad) // CHUNK, CHUNK

    def chunks(x):  # (B, S, H, D) -> (B, H, N, C, D), rows past S zero
        x = F.pad(x.transpose(1, 2), (0, 0, 0, pad))
        return x.reshape(b, h, n, c, x.shape[-1])

    q = chunks((qn * scale).repeat_interleave(rep, dim=2))
    k = chunks(kn.repeat_interleave(rep, dim=2))
    v, do = chunks(value.float()), chunks(d_out.float())
    gg, bt = (F.pad(x.float().transpose(1, 2), (0, pad)).reshape(b, h, n, c) for x in (g, beta))
    big_g = torch.cumsum(gg, dim=-1)
    eg, e_last = torch.exp(big_g), torch.exp(big_g[..., -1])
    el = torch.exp(big_g[..., -1:] - big_g)
    idx = torch.arange(c, device=q.device)
    lower_incl = idx[None, :] <= idx[:, None]
    strict = idx[None, :] < idx[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    gam = torch.where(lower_incl, torch.exp(torch.where(lower_incl, big_g[..., :, None] - big_g[..., None, :], zero)),
                      zero)
    kk = k @ k.transpose(-1, -2)
    t_mat = torch.where(strict, -bt[..., None] * kk * gam, zero)
    p_mat = (q @ k.transpose(-1, -2)) * gam
    m_mat = torch.eye(c, dtype=torch.float32, device=q.device) - t_mat
    states, vns = [], []
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    for i in range(n):
        states.append(state)
        u = bt[:, :, i, :, None] * (v[:, :, i] - eg[:, :, i, :, None] * (k[:, :, i] @ state))
        vn = torch.linalg.solve_triangular(m_mat[:, :, i], u, upper=False, unitriangular=True)
        vns.append(vn)
        state = state * e_last[:, :, i, None, None] + (k[:, :, i] * el[:, :, i, :, None]).transpose(-1, -2) @ vn
    dq, dk_, dv_, dgg, dbt = (torch.zeros_like(x) for x in (q, k, v, gg, bt))
    d_state = torch.zeros_like(state)
    for i in reversed(range(n)):
        s_i, vn, q_i, k_i, do_i = states[i], vns[i], q[:, :, i], k[:, :, i], do[:, :, i]
        eg_i, el_i, bt_i = eg[:, :, i, :, None], el[:, :, i, :, None], bt[:, :, i, :, None]
        gam_i, t_i, p_i = gam[:, :, i], t_mat[:, :, i], p_mat[:, :, i]
        ks_ = k_i @ s_i
        kd_ds = (k_i * el_i) @ d_state
        d_vn = kd_ds + p_i.transpose(-1, -2) @ do_i
        d_u = torch.linalg.solve_triangular(m_mat[:, :, i].transpose(-1, -2), d_vn, upper=True, unitriangular=True)
        dv_[:, :, i] = bt_i * d_u
        d_ks = -(bt_i * eg_i) * d_u
        d_p = torch.where(lower_incl, do_i @ vn.transpose(-1, -2), zero)
        d_t = torch.where(strict, d_u @ vn.transpose(-1, -2), zero)
        d_qk = d_p * gam_i
        d_kk = -bt_i * d_t * gam_i
        e = d_p * p_i + d_t * t_i
        r = (vn * kd_ds).sum(-1)
        d_big_g = (eg_i[..., 0] * ((q_i @ s_i) * do_i).sum(-1) - (bt_i * eg_i)[..., 0] * (d_u * ks_).sum(-1) - r
                   + e.sum(-1) - e.sum(-2))
        d_big_g[..., -1] += e_last[:, :, i] * (s_i * d_state).sum((-2, -1)) + r.sum(-1)
        dbt[:, :, i] = (d_t * -(kk[:, :, i] * gam_i)).sum(-1) + (d_u * (v[:, :, i] - eg_i * ks_)).sum(-1)
        dgg[:, :, i] = torch.flip(torch.cumsum(torch.flip(d_big_g, [-1]), -1), [-1])
        dq[:, :, i] = (eg_i * do_i) @ s_i.transpose(-1, -2) + d_qk @ k_i
        dk_[:, :, i] = ((el_i * vn) @ d_state.transpose(-1, -2) + d_ks @ s_i.transpose(-1, -2)
                        + d_qk.transpose(-1, -2) @ q_i + (d_kk + d_kk.transpose(-1, -2)) @ k_i)
        d_state = e_last[:, :, i, None, None] * d_state + q_i.transpose(-1, -2) @ (eg_i * do_i) + \
            k_i.transpose(-1, -2) @ d_ks

    def unchunk(x):  # (B, H, N, C, D) -> (B, S, H, D)
        return x.reshape(b, h, n * c, x.shape[-1])[:, :, :s].transpose(1, 2)

    def l2norm_backward(x, x_hat, dx_hat):  # x_hat = l2norm(x)
        return torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6) * (dx_hat - x_hat * (x_hat * dx_hat).sum(-1, True))

    dq_hat = unchunk(dq).reshape(b, s, hk, rep, dk).sum(3) * scale
    dk_hat = unchunk(dk_).reshape(b, s, hk, rep, dk).sum(3)
    return (l2norm_backward(qx, qn, dq_hat), l2norm_backward(kx, kn, dk_hat), unchunk(dv_),
            dgg.reshape(b, h, n * c)[:, :, :s].transpose(1, 2), dbt.reshape(b, h, n * c)[:, :, :s].transpose(1, 2))


def _check_rows(name: str, t: torch.Tensor, heads: int, dim: int) -> int:
    """The token stride of a ``(B, S, H, D)`` view whose heads lie ``D``
    apart and whose batch rows lie ``S`` tokens apart (a slice of a wider
    row, like the conv's output, is taken as it is)."""
    b, s = t.shape[:2]
    if t.stride(3) != 1 or t.stride(2) != dim or (b > 1 and t.stride(0) != s * t.stride(1)) or \
            t.stride(1) < heads * dim:
        raise ValueError(f"{name} {tuple(t.shape)} with strides {t.stride()}: the kernel reads rows of H x D "
                         "contiguous values, S rows a batch entry")
    return t.stride(1)


def _check_cuda_inputs(query, key, value, g, beta) -> tuple:
    """The kernel's checks; returns the token strides ``(ld_qk, ld_v)``."""
    _check_shapes(query, key, value, g, beta)
    dk, hk = query.shape[3], query.shape[2]
    hv, dv = value.shape[2], value.shape[3]
    dtype, dev = query.dtype, query.device
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"query has dtype {dtype}; the kernel takes bfloat16 or float32")
    if dk not in KEY_DIMS or dv % VALUE_BLOCK:
        raise ValueError(f"Dk={dk}, Dv={dv}: the kernel takes Dk in {KEY_DIMS} and Dv a multiple of {VALUE_BLOCK}")
    for name, t in (("key", key), ("value", value), ("beta", beta)):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; expected {dtype} on {dev}")
    ld_qk = _check_rows("query", query, hk, dk)
    if _check_rows("key", key, hk, dk) != ld_qk:
        raise ValueError("query and key must share their token stride")
    ld_v = _check_rows("value", value, hv, dv)
    check_cuda("g", g, torch.float32, dev)
    check_cuda("beta", beta, dtype, dev)
    return ld_qk, ld_v


def _forward_cuda(query, key, value, g, beta, states) -> torch.Tensor:
    """One launch of Q2 (``states``: the buffer for the chunks' starting states, or None)."""
    ld_qk, ld_v = _check_cuda_inputs(query, key, value, g, beta)
    b, s, hk, _ = query.shape
    hv, dv = value.shape[2], value.shape[3]
    out = torch.empty((b, s, hv, dv), dtype=query.dtype, device=query.device)
    if b and s:
        GATED_DELTA_RULE(query.device, query.data_ptr(), key.data_ptr(), value.data_ptr(), g.data_ptr(),
                         beta.data_ptr(), out.data_ptr(), 0 if states is None else states.data_ptr(), b, s, hk, hv,
                         dv, int(query.dtype == torch.bfloat16), ld_qk, ld_v)
    return out


def chunk_gated_delta_rule_backward(query, key, value, g, beta, states, d_out) -> tuple:
    """Q2's backward kernel (two launches, counted once): ``(dq, dk, dv, dg,
    dbeta)`` from the forward's inputs, the chunks' starting states it wrote
    (``(B, Hv, ceil(S / 64), 128, Dv)`` fp32) and ``d_out``; dq, dk, dv and
    dbeta contiguous in the inputs' dtype, dg fp32."""
    ld_qk, ld_v = _check_cuda_inputs(query, key, value, g, beta)
    b, s, hk, dk = query.shape
    hv, dv = value.shape[2], value.shape[3]
    dtype, dev = query.dtype, query.device
    check_cuda("states", states, torch.float32, dev)
    if tuple(states.shape) != (b, hv, -(-s // CHUNK), dk, dv):
        raise ValueError(f"states {tuple(states.shape)} != {(b, hv, -(-s // CHUNK), dk, dv)}")
    d_out = d_out.to(dtype).contiguous()
    if tuple(d_out.shape) != (b, s, hv, dv) or d_out.device != dev:
        raise ValueError(f"d_out {tuple(d_out.shape)} on {d_out.device} != {(b, s, hv, dv)} on {dev}")
    dq, dk_ = (torch.empty((b, s, hk, dk), dtype=dtype, device=dev) for _ in range(2))
    dv_ = torch.empty((b, s, hv, dv), dtype=dtype, device=dev)
    dg = torch.empty((b, s, hv), dtype=torch.float32, device=dev)
    dbeta = torch.empty((b, s, hv), dtype=dtype, device=dev)
    scratch = torch.empty(2 * b * s * hv * (dv // VALUE_BLOCK) * (dk + 1), dtype=torch.float32, device=dev)
    GATED_DELTA_RULE_BWD(dev, query.data_ptr(), key.data_ptr(), value.data_ptr(), g.data_ptr(), beta.data_ptr(),
                         states.data_ptr(), d_out.data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
                         dg.data_ptr(), dbeta.data_ptr(), scratch.data_ptr(), b, s, hk, hv, dv,
                         int(dtype == torch.bfloat16), ld_qk, ld_v)
    return dq, dk_, dv_, dg, dbeta


class GatedDeltaRule(torch.autograd.Function):
    """Q2 with its backward kernel: the forward launches Q2 and keeps the
    fp32 state at each chunk's start (B x Hv x ceil(S/64) x 128 x Dv x 4
    bytes: 201 MB at B=8 S=753 Hv=32); the backward launches
    :func:`chunk_gated_delta_rule_backward`."""

    @staticmethod
    def forward(ctx, query, key, value, g, beta):
        b, s = query.shape[:2]
        hv, dv = value.shape[2], value.shape[3]
        states = torch.empty((b, hv, -(-s // CHUNK), query.shape[3], dv), dtype=torch.float32, device=query.device)
        out = _forward_cuda(query, key, value, g, beta, states)
        ctx.save_for_backward(query, key, value, g, beta, states)
        return out

    @staticmethod
    def backward(ctx, d_out):
        return chunk_gated_delta_rule_backward(*ctx.saved_tensors, d_out)


def chunk_gated_delta_rule(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, g: torch.Tensor,
                           beta: torch.Tensor) -> torch.Tensor:
    """The chunked gated delta rule (see the module docstring): kernel Q2
    for CUDA tensors, the plain version for CPU tensors. On the card
    ``query``, ``key``, ``value`` and ``beta`` share one dtype (bf16 or
    fp32) and ``g`` is fp32; a call whose inputs need a gradient goes
    through :class:`GatedDeltaRule` (the backward kernel)."""
    if on_cpu(query):
        return chunk_gated_delta_rule_plain(query, key, value, g, beta)
    beta = beta.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value, g, beta)):
        return GatedDeltaRule.apply(query, key, value, g, beta)
    return _forward_cuda(query, key, value, g, beta, None)
