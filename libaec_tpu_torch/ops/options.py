"""Per-block code-option search, twin of libaec_tpu/ops/options.py.

The JAX package keeps each 39-bit CDS length as a (hi, lo) pair of u32
halves because its arrays have no 64-bit integers.  torch has int64, so
the lengths here are exact int64 values: comparing them is the pair
comparison of the JAX package, and the u32 truncation of encode.c:409 is
`& MASK32`.  The k domain is the K = kmax + 1 values the chain can take
(the Pallas kernel's K_dom).
"""
import torch
import torch.nn.functional as F

from .u32 import MASK32

OPT_SPLIT = 0
OPT_SE = 1
OPT_UNCOMP = 2


def fs_tables(d_blk, K):
    """fs_len(k) = sum_i(d_i >> k) for k in [0, K): int64 [NB, K]."""
    return torch.stack([(d_blk >> k).sum(dim=-1) for k in range(K)], dim=-1)


def fs_tables_lanes(d_blk, K, bps):
    """`fs_tables` the way the CUDA kernel computes it (csrc/encode.cu,
    fs_sums): a lane takes one k.  Up to 16 values of k it takes half of
    the block's samples (the first 32, or the rest), and the two halves'
    sums are added.  Up to 25-bit samples a lane's sum and the split
    lengths made of it are kept in 32 bits (64 * 2^25 + 64 * 32 < 2^32:
    they wrap here as they would there); wider ones in 64 bits.  Only tests
    call it."""
    parts = [d_blk[:, :32], d_blk[:, 32:]] if K <= 16 else [d_blk]
    cols = []
    for k in range(K):
        sums = [(part >> k).sum(dim=-1) for part in parts]
        if bps <= 25:
            sums = [s & MASK32 for s in sums]
        cols.append(sum(sums))
    return torch.stack(cols, dim=-1)


def split_lengths(fs, this_bs):
    """L(k) = fs_len(k) + this_bs * (k + 1), exact int64 [NB, K]."""
    kk = torch.arange(fs.shape[1], dtype=torch.int64, device=fs.device)
    return fs + this_bs[:, None] * (kk[None, :] + 1)


def k_walk_maps(fs, L, this_bs, kmax, searched):
    """Closed form of the warm-start walk for every incoming k
    (options.k_walk_maps, encode.c:356-409): maps[b, k0] is the k the
    reference's assess_splitting_option returns for block b when entered
    with state->k == k0.  Blocks with searched[b] False (zero blocks) get
    the identity map."""
    K = L.shape[1]
    kk = torch.arange(K, dtype=torch.int64, device=L.device)[None, :]
    L1 = torch.cat([L[:, 1:], L[:, -1:]], dim=1)          # L(k+1), edge
    A = (kk >= kmax) | (L1 >= L)                          # ascent stops
    # up(k0) = min{k >= k0 : A(k)}: reverse cumulative min
    upv = torch.where(A, kk, torch.full_like(kk, K - 1))
    up = torch.flip(torch.cummin(torch.flip(upv, [1]), dim=1).values, [1])
    fs_small = fs < this_bs[:, None]
    Lm1 = torch.cat([L[:, :1], L[:, :-1]], dim=1)          # L(k-1), edge
    prev_lt = Lm1 < L
    C = (kk > 0) & fs_small & prev_lt
    cm = torch.cummax(torch.where(~C, kk, torch.full_like(kk, -1)),
                      dim=1).values
    cm_m1 = F.pad(cm, (1, 0))[:, :-1]
    res_down = torch.where(prev_lt, cm_m1, kk)
    cond_up = (kk == 0) | ~A
    f = torch.where(cond_up, up, res_down).clamp(0, K - 1)
    return torch.where(searched[:, None], f, kk.expand_as(f))


def prefix_compose(maps):
    """Inclusive prefix composition of int64 maps [N, K]:
    out[b][i] = maps[b][out[b-1][i]] (backend.prefix_compose).
    Log-doubling."""
    P = maps.clone()
    n = P.shape[0]
    s = 1
    while s < n:
        P = torch.cat([P[:s], torch.gather(P[s:], 1, P[:-s])], dim=0)
        s *= 2
    return P


def chain_k(maps, k_init):
    """Compose the per-block maps in stream order from k_init (an int64
    [1] tensor).  Returns (chosen_k int64 [NB] -- the k each block's
    search ends at, k_final int64 [1])."""
    P = prefix_compose(maps)
    col = torch.gather(P, 1, k_init.reshape(1, 1).expand(P.shape[0], 1))
    chosen = col[:, 0]
    return chosen, chosen[-1:]


def _compose_runs(m):
    """m: int64 maps [N, R, K], N runs of R maps each.  Returns the N run
    composites [N, K]: each run's maps composed left to right."""
    n, r, k = m.shape
    c = torch.arange(k, dtype=torch.int64, device=m.device).expand(n, k)
    for s in range(r):
        c = torch.gather(m[:, s], 1, c)
    return c


def _walk_runs(m, k_in):
    """m: int64 maps [N, R, K]; k_in: int64 [N], the k entering each run.
    Returns (the k entering each map, the k leaving it), both [N, R]."""
    ins, outs, k = [], [], k_in
    for s in range(m.shape[1]):
        ins.append(k)
        k = torch.gather(m[:, s], 1, k[:, None])[:, 0]
        outs.append(k)
    return torch.stack(ins, 1), torch.stack(outs, 1)


def _runs_of(maps, length):
    """maps [N, K] as [ceil(N / length), length, K], padded with identity
    maps."""
    n, k = maps.shape
    pad = -n % length
    ident = torch.arange(k, dtype=torch.int64, device=maps.device)
    return torch.cat([maps, ident.expand(pad, k)]).view(-1, length, k)


def chain_k_tiled(maps, k_init, tile=64, runs=32):
    """`chain_k` the way the CUDA kernel computes it (csrc/encode.cu): a
    tile of `tile` consecutive blocks has a composite map; the tiles are
    dealt over `runs` contiguous runs, each with a composite of its own;
    the run composites are chained one by one from k_init (clamped to the
    maps' domain); every run is walked from the k that enters it, which
    gives each tile's incoming k; every tile is walked from that, which
    gives each block's k.  Dependent steps: tile + run length + runs + run
    length + tile, not NB.

    Returns (chosen_k int64 [NB], k_final int64 [1], the tile composites
    int64 [nt, K], tile_kin int64 [nt]).  Only tests call it."""
    nb, k = maps.shape
    m = _runs_of(maps, tile)                      # [nt, tile, K]
    comp = _compose_runs(m)
    nt = comp.shape[0]
    c = _runs_of(comp, -(-nt // runs))            # [<= runs, run, K]
    run_comp = _compose_runs(c)
    kk = int(k_init.reshape(-1)[0].clamp(0, k - 1))
    run_kin = []
    for w in range(run_comp.shape[0]):
        run_kin.append(kk)
        kk = int(run_comp[w, kk])
    run_kin = torch.tensor(run_kin, dtype=torch.int64, device=maps.device)
    tile_kin = _walk_runs(c, run_kin)[0].reshape(-1)[:nt]
    chosen = _walk_runs(m, tile_kin)[1].reshape(-1)[:nb]
    k_final = torch.tensor([kk], dtype=torch.int64, device=maps.device)
    return chosen, k_final, comp, tile_kin


def se_lengths(d_blk, uncomp_len):
    """Second-extension comparison length (assess_se_option,
    encode.c:412-434) and the per-pair fs values.

    SE is only selected when every pair sum is below 128; the fs values of
    other pairs are never emitted, so they are computed from a clamped sum
    (the JAX package's u32 product would wrap there, int64's could
    overflow)."""
    a = d_blk[:, 0::2]
    b = d_blk[:, 1::2]
    dsum = (a + b) & MASK32
    small = (dsum >= a) & (dsum < 128)
    ds = torch.where(small, dsum, torch.zeros_like(dsum))
    fs_exact = ds * (ds + 1) // 2 + b
    fs = torch.where(small, fs_exact, torch.full_like(fs_exact, 1 << 20))
    total = 1 + (fs + 1).sum(dim=-1)
    se_len = torch.where(total > uncomp_len,
                         torch.full_like(total, MASK32), total)
    return se_len, fs_exact


def select_option(split32, se_len, uncomp_len):
    """m_select_code_option precedence (encode.c:585-612)."""
    pick_split = (split32 < uncomp_len) & (split32 < se_len)
    pick_uncomp = ~(split32 < uncomp_len) & (uncomp_len <= se_len)
    return torch.where(
        pick_split, OPT_SPLIT,
        torch.where(pick_uncomp, OPT_UNCOMP, OPT_SE))
