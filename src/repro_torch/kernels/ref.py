"""Plain PyTorch versions of the kernels: the ground truth the CUDA kernels
are held against, and what :mod:`.ops` runs on CPU tensors."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal=True, window=None, p_dtype=None):
    """q (B,T,H,hd); k/v (B,S,K,hd) — exact softmax attention in fp32.
    ``p_dtype`` (e.g. bf16) rounds the probabilities to that type before
    P·V, as the tensor-core flash kernel does; None keeps them in fp32."""
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, T, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, T, H, hd).to(q.dtype)


def paged_decode_reference(q, pages_k, pages_v, page_table, lengths):
    """q (B,H,hd); pages_* (P, page, K, hd); page_table (B, maxp) int32;
    lengths (B,) int32 — exact paged decode attention.

    A row with ``length == 0`` gives zeros, as the TPU kernel does
    (``repro.kernels.ref`` gives the mean of V there instead)."""
    B, H, hd = q.shape
    P, page, K, _ = pages_k.shape
    maxp = page_table.shape[1]
    G = H // K
    idx = page_table.long()
    kg = pages_k[idx].reshape(B, maxp * page, K, hd)
    vg = pages_v[idx].reshape(B, maxp * page, K, hd)
    qg = q.reshape(B, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kg.float())
    valid = torch.arange(maxp * page, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.where(valid[:, None, None], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, vg.float())
    return o.reshape(B, H, hd).to(q.dtype)


def paged_decode_partials_reference(q, pages_k, pages_v, page_table, lengths, split_len: int):
    """Plain version of the split kernel of paged decode. The capacity
    ``maxp·page`` is cut into splits of ``split_len`` positions; per
    (sequence, kv head, split) and query row: m = the split's largest valid
    scaled score, l = Σ exp(s − m), acc = Σ exp(s − m)·v, all fp32. A split
    with no valid position gives m = −1e30, l = 0, acc = 0. Returns m, l
    (B,K,splits,G) and acc (B,K,splits,G,hd)."""
    B, H, hd = q.shape
    P, page, K, _ = pages_k.shape
    maxp = page_table.shape[1]
    G = H // K
    cap = maxp * page
    splits = max(1, -(-cap // split_len))
    pad = splits * split_len - cap
    idx = page_table.long()
    kg = F.pad(pages_k[idx].reshape(B, cap, K, hd).float(), (0, 0, 0, 0, 0, pad))
    vg = F.pad(pages_v[idx].reshape(B, cap, K, hd).float(), (0, 0, 0, 0, 0, pad))
    kg = kg.reshape(B, splits, split_len, K, hd)
    vg = vg.reshape(B, splits, split_len, K, hd)
    qg = q.reshape(B, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgd,bcjkd->bkcgj", qg, kg)  # (B,K,splits,G,split_len)
    pos = torch.arange(splits * split_len, device=q.device).reshape(splits, split_len)
    valid = (pos[None] < lengths.long().clamp(max=cap)[:, None, None])[:, None, :, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkcgj,bcjkd->bkcgd", p, vg)
    return m, p.sum(dim=-1), acc


def combine_partials_reference(m, l, acc, dtype):
    """Plain version of the combine kernel: o = Σ_s w_s·acc_s / Σ_s w_s·l_s
    with w_s = exp(m_s − max m), zeros where the total l is 0. m, l
    (B,K,splits,G), acc (B,K,splits,G,hd) → (B, K·G, hd) in ``dtype``."""
    B, K, _, G, hd = acc.shape
    w = torch.exp(m - m.amax(dim=2, keepdim=True))
    total = (w * l).sum(dim=2)
    o = (w[..., None] * acc).sum(dim=2)
    o = torch.where(total[..., None] == 0, 0.0, o / torch.where(total == 0, 1.0, total)[..., None])
    return o.reshape(B, K * G, hd).to(dtype)


def ssd_chunk_reference(x, dA, B_, C_):
    """Sequential SSD oracle. x (b,t,h,p); dA (b,t,h) log decay; B_/C_
    (b,t,g,n). The state is carried in fp32. Returns (y in x's dtype,
    final state (b,h,p,n) fp32)."""
    b, t, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    hpg = h // g
    st = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    xg = x.float()
    for i in range(t):
        dec = torch.exp(dA[:, i].float())  # (b,h)
        Bx = torch.einsum("bgn,bghp->bghpn", B_[:, i].float(), xg[:, i].reshape(b, g, hpg, p))
        st = st * dec[:, :, None, None] + Bx.reshape(b, h, p, n)
        y = torch.einsum("bgn,bghpn->bghp", C_[:, i].float(), st.reshape(b, g, hpg, p, n))
        ys.append(y.reshape(b, h, p))
    return torch.stack(ys, dim=1).to(x.dtype), st


def _chunked(a: torch.Tensor, chunk: int) -> torch.Tensor:
    """(b,t,...) → (b,nc,chunk,...) in fp32, the ragged tail padded with zeros
    (an identity step: dA = 0, x = B = C = 0)."""
    b, t = a.shape[:2]
    nc = -(-t // chunk)
    a = F.pad(a.float(), (0, 0) * (a.ndim - 2) + (0, nc * chunk - t))
    return a.reshape(b, nc, chunk, *a.shape[2:])


def ssd_states_reference(x, dA, B_, C_, chunk: int):
    """Plain version of the ``ssd_states`` kernel (g = 1). Per (batch, chunk,
    head): ``y_diag = (C·Bᵀ ⊙ L)·x`` with ``L = exp(cum_i − cum_j)`` for
    i ≥ j, and the chunk state ``S = xᵀ·(B ⊙ exp(cum[-1] − cum))``, all in
    fp32. Returns y_diag (b,nc,h,cs,p) and S (b,nc,h,p,n)."""
    xc = _chunked(x, chunk)  # (b,nc,cs,h,p)
    cum = torch.cumsum(_chunked(dA, chunk), dim=2)  # (b,nc,cs,h)
    Bc, Cc = _chunked(B_[:, :, 0], chunk), _chunked(C_[:, :, 0], chunk)  # (b,nc,cs,n)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,h)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal[:, :, None], seg, NEG_INF))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * L
    y_diag = torch.einsum("bcijh,bcjhp->bchip", scores, xc)
    decay = torch.exp(cum[:, :, -1:] - cum)  # (b,nc,cs,h)
    S = torch.einsum("bcjhp,bcjn->bchpn", xc * decay[..., None], Bc)
    return y_diag, S


def bf16x3(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 SSD kernels' three-term split of an fp32 tensor: hi, mid and
    lo are bf16 values (returned in fp32), each rounded to nearest from what
    the terms before it leave, and hi + mid + lo == v. A fp32 operand enters
    the tensor cores as these three terms, so nothing is rounded."""
    hi = v.to(torch.bfloat16).float()
    mid = (v - hi).to(torch.bfloat16).float()
    return hi, mid, (v - hi - mid).to(torch.bfloat16).float()


def ssd_output_reference(y_diag, dA, C_, H_in, dtype: torch.dtype):
    """Plain version of the ``ssd_output`` kernel (g = 1):
    ``y = y_diag + (C ⊙ exp(cum))·H_inᵀ`` per (batch, chunk, head), in fp32,
    written as (b,t,h,p) in ``dtype``. y_diag (b,nc,h,cs,p) and H_in
    (b,nc,h,p,n) fp32; dA (b,t,h); C_ (b,t,1,n)."""
    b, nc, h, cs, p = y_diag.shape
    t = dA.shape[1]
    cum = torch.cumsum(_chunked(dA, cs), dim=2)  # (b,nc,cs,h)
    Cd = _chunked(C_[:, :, 0], cs)[:, :, :, None, :] * torch.exp(cum)[..., None]  # (b,nc,cs,h,n)
    y = y_diag + torch.einsum("bcihn,bchpn->bchip", Cd, H_in)
    return y.permute(0, 1, 3, 2, 4).reshape(b, nc * cs, h, p)[:, :t].to(dtype)


def rglru_reference(x, r, i, lam, h0=None):
    """Sequential RG-LRU in fp32. x/r/i (B,T,W); lam (W,); h0 (B,W) or None
    (zeros). ``a = exp(r·(−8·softplus(λ)))``, ``β = √max(1 − a², 1e-12)``
    with a² as ``exp(2·log a)``, ``h = a·h + β·(i·x)``; softplus without a
    threshold. Returns (y (B,T,W) in x's dtype, h_last (B,W) fp32)."""
    B, T, W = x.shape
    lam = lam.float()
    log_a_base = -8.0 * (lam.clamp(min=0) + torch.log1p(torch.exp(-lam.abs())))
    h = torch.zeros((B, W), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    ys = []
    for t in range(T):
        log_a = r[:, t].float() * log_a_base
        a = torch.exp(log_a)
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
        h = a * h + beta * (i[:, t].float() * x[:, t].float())
        ys.append(h)
    return torch.stack(ys, dim=1).to(x.dtype), h


def rglru_chunked_reference(x, r, i, lam, h0=None, chunk: int = 64, sub: int | None = None,
                            runs: int | None = None):
    """The CUDA kernel's decomposition of the RG-LRU, in plain PyTorch: the
    same function as :func:`rglru_reference` in another summation order, for
    tests (nothing on the serving path calls it). T is cut into chunks of
    ``chunk`` steps, each into sub-chunks of ``sub`` (None: the whole chunk);
    steps past T are identities (a = 1, u = 0). Each sub-chunk runs from
    h = 0 to (∏a, h); the sub-chunks fold in order into the chunk's (A, U).
    The h entering chunk c: with ``runs`` None, the chunks before it folded
    in order from h0; with ``runs`` n, those c chunks cut into n runs of
    ⌈c/n⌉, each folded in order from the identity, then the runs folded in
    order from h0. It folds on through the sub-chunks into the h entering
    each sub-chunk, and each sub-chunk runs again from there. The kernel
    takes chunk 128, sub 16, runs 8."""
    B, T, W = x.shape
    sub = chunk if sub is None else sub
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of sub {sub}")
    lam = lam.float()
    log_a = r.float() * (-8.0 * (lam.clamp(min=0) + torch.log1p(torch.exp(-lam.abs()))))
    a = torch.exp(log_a)
    u = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i.float() * x.float())
    nc, n_sub = -(-T // chunk), chunk // sub
    pad = (0, 0, 0, nc * chunk - T)
    a = F.pad(a, pad, value=1.0).view(B, nc, n_sub, sub, W)
    u = F.pad(u, pad).view(B, nc, n_sub, sub, W)
    prod = torch.ones((B, nc, n_sub, W), dtype=torch.float32, device=x.device)
    h = torch.zeros_like(prod)
    for k in range(sub):
        h = a[:, :, :, k] * h + u[:, :, :, k]
        prod = prod * a[:, :, :, k]
    A, U = prod[:, :, 0], h[:, :, 0]
    for j in range(1, n_sub):
        U = prod[:, :, j] * U + h[:, :, j]
        A = A * prod[:, :, j]
    h_init = torch.zeros((B, W), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    carry, starts = h_init, []
    for c in range(nc):
        if runs is not None:  # the kernel's runs, each from the identity
            n, carry = -(-c // runs), h_init
            for j in range(runs):
                run_a, run_u = torch.ones_like(h_init), torch.zeros_like(h_init)
                for k in range(min(c, j * n), min(c, j * n + n)):
                    run_u = A[:, k] * run_u + U[:, k]
                    run_a = run_a * A[:, k]
                carry = run_a * carry + run_u
        hs = carry
        for j in range(n_sub):
            starts.append(hs)
            hs = prod[:, c, j] * hs + h[:, c, j]
        carry = A[:, c] * carry + U[:, c]
    h = torch.stack(starts, dim=1).view(B, nc, n_sub, W)
    ys = []
    for k in range(sub):
        h = a[:, :, :, k] * h + u[:, :, :, k]
        ys.append(h)
    y = torch.stack(ys, dim=3).reshape(B, nc * chunk, W)
    return y[:, :T].to(x.dtype), y[:, -1].clone()  # steps past T leave h as it was at T - 1


def _padded(src: torch.Tensor) -> torch.Tensor:
    """src (M, d) with a row of zeros appended at index M, the pad index."""
    return torch.cat([src, src.new_zeros(1, src.shape[1])])


def gather_rows_reference(src, idx):
    """src (M, d), idx (R,) int64 in [0, M] → (R, d): ``src[idx[r]]``, zeros
    where ``idx[r] == M``."""
    return _padded(src)[idx]


def gather_sum_rows_reference(src, places, fp32_sum: bool = False):
    """src (M, d), places (N, k) int64 in [0, M] → (N, d): ``Σ_j
    src[places[n, j]]`` in j order, a place M adding a zero row. Rounded to
    src's dtype after each add as ``y = y + src[places[:, j]]`` does, or with
    ``fp32_sum`` summed from zero in fp32 (src's dtype where wider) and
    rounded once."""
    if fp32_sum:
        rows = _padded(src.to(torch.promote_types(src.dtype, torch.float32)))
        out = rows.new_zeros(places.shape[0], src.shape[1])
        for j in range(places.shape[1]):
            out = out + rows[places[:, j]]
        return out.to(src.dtype)
    rows = _padded(src)
    out = rows[places[:, 0]]
    for j in range(1, places.shape[1]):
        out = out + rows[places[:, j]]
    return out
