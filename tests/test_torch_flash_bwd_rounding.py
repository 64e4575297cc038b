"""The bf16 flash backward kernels' schedule and roundings, rehearsed on the
CPU.

``flash_backward.cu``'s bf16 kernels (``flash_bwd_dkdv_wgmma_kernel`` and
``flash_bwd_dq_wgmma_kernel``) cut the work into blocks of kWgGroups
warpgroups of kWgRows rows each (both read from the source here, so the
rehearsal follows the kernel). The dK/dV block owns a run of keys and walks,
for each of the G heads of its kv head, the query tiles from the first whose
last row attends its first key (causal) to the last; a warpgroup skips a
tile none of whose rows attends its keys, and masks a tile only where a row
may not attend one of its keys or the tile runs past Sq. The dQ block owns
a run of query rows of one head and walks the key tiles up to the last key
its last row attends, with the same skip and mask rules. ``_walk_dkdv`` and
``_walk_dq`` are those rules in Python.

``_emulate`` runs the kernels' arithmetic along that schedule in plain
PyTorch on the CPU: bf16 operands with f32 sums; P = exp2(scale log2(e) s -
log2(e) lse); P rounded to bf16 only as dV's operand; dS = P (dP - di) from
the f32 P, rounded to bf16 only as dK's and dQ's operand; di = rowsum(dO o)
in f32 over the bf16 output; the three gradients rounded to bf16 once, at
the end, as the kernels store them. On seeded numpy inputs (bf16 values) at
reduced widths, D 64, 80 and 128, groups 1, 3 and 6, Sq < Skv, ragged
tiles, causal and not, it stays within BOUND (the card's 2e-2 of each
gradient's scale, halved) of ``jax.vjp`` of the JAX package's
``flash_attention_chunked`` and of the port's ``ref.flash_attention_bwd``,
both in f32 on the same inputs. Every attended (query, key) pair is visited
exactly once per gradient, and no other pair contributes.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "csrc" / "flash_backward.cu")
R = 64       # kWgRows: rows (keys or queries) a warpgroup owns
GROUPS = 2   # kWgGroups: warpgroups a block
BLOCK = R * GROUPS
BOUND = 1e-2  # the card's bf16 bound 2e-2, halved
LOG2E = 1.4426950408889634

# (B, Sq, Skv, H, KVH, D, causal)
CASES = {
    "D64 G3 causal Sq<Skv": (1, 150, 200, 3, 1, 64, True),
    "D80 G1 cross": (2, 45, 200, 2, 2, 80, False),
    "D128 G6 causal": (1, 130, 130, 6, 1, 128, True),
    "D64 G6 causal": (1, 192, 192, 6, 1, 64, True),
}
# (Sq, Skv, causal) of the schedule checks: square and ragged, Sq < Skv,
# Sq below one tile, a long causal walk
WALKS = [(64, 64, True), (100, 100, False), (37, 300, False), (45, 320, True),
         (200, 200, True), (256, 384, True), (700, 700, True), (1, 9, True)]


def test_kernel_constants():
    """The rehearsal's tile and block sizes are the kernels'."""
    text = SOURCE.read_text()
    assert re.search(r"constexpr int kWgRows = (\d+);", text).group(1) == \
        str(R)
    assert re.search(r"constexpr int kWgGroups = (\d+);", text).group(1) == \
        str(GROUPS)


def _lim(p, sq, skv, causal):
    """The last key query position p attends; -1 past the last position."""
    if p >= sq:
        return -1
    return min(skv - 1, skv - sq + p) if causal else skv - 1


def _walk_dkdv(sq, skv, group, causal):
    """(k0 of the block, head g, first row p0, warpgroup's first key kw,
    masked) of every tile a dK/dV warpgroup computes, in the kernel's
    order."""
    n_qt = -(-sq // R)
    for k0 in range(0, skv, BLOCK):
        t_first = max(0, k0 - (skv - sq)) // R if causal else 0
        per_head = n_qt - t_first
        for t in range(group * per_head):
            g, p0 = t // per_head, (t_first + t % per_head) * R
            for wg in range(GROUPS):
                kw = k0 + wg * R
                if kw > _lim(min(p0 + R, sq) - 1, sq, skv, causal):
                    continue
                masked = (kw + R - 1 > _lim(p0, sq, skv, causal)
                          or p0 + R > sq)
                yield k0, g, p0, kw, masked


def _walk_dq(sq, skv, causal):
    """(warpgroup's first row wrow, first key kt0, masked) of every tile a
    dQ warpgroup computes (the same for every head)."""
    for p0 in range(0, sq, BLOCK):
        n_keys = _lim(min(p0 + BLOCK, sq) - 1, sq, skv, causal) + 1
        for kt0 in range(0, n_keys, R):
            for wg in range(GROUPS):
                wrow = p0 + wg * R
                hi = (_lim(min(wrow + R, sq) - 1, sq, skv, causal)
                      if wrow < sq else -1)
                if kt0 > hi:
                    continue
                masked = (kt0 + R - 1 > _lim(wrow, sq, skv, causal)
                          or wrow + R > sq)
                yield wrow, kt0, masked


def _tile_mask(p0, k0, sq, skv, causal, masked):
    """(R query rows, R keys) of the pairs a tile adds: every pair of an
    unmasked tile, else the attended ones."""
    if not masked:
        return torch.ones(R, R, dtype=torch.bool)
    lims = torch.tensor([_lim(p0 + i, sq, skv, causal) for i in range(R)])
    return (k0 + torch.arange(R))[None, :] <= lims[:, None]


def _attended(sq, skv, causal):
    lims = torch.tensor([_lim(p, sq, skv, causal) for p in range(sq)])
    return torch.arange(skv)[None, :] <= lims[:, None]


@pytest.mark.parametrize("sq,skv,causal", WALKS)
def test_schedule_visits_each_pair_once(sq, skv, causal):
    """Each walk adds every attended (query, key) pair once and no other
    pair (the visit counts are padded to whole blocks: a pair past Sq or
    Skv would show there)."""
    pad_q, pad_k = -(-sq // BLOCK) * BLOCK, -(-skv // BLOCK) * BLOCK + BLOCK
    for walk in ("dkdv", "dq"):
        seen = torch.zeros(pad_q, pad_k, dtype=torch.int32)
        tiles = (((p0, kw, m) for _, g, p0, kw, m in
                  _walk_dkdv(sq, skv, 1, causal)) if walk == "dkdv" else
                 _walk_dq(sq, skv, causal))
        for p0, k0, masked in tiles:
            seen[p0:p0 + R, k0:k0 + R] += _tile_mask(
                p0, k0, sq, skv, causal, masked).int()
        want = torch.zeros_like(seen)
        want[:sq, :skv] = _attended(sq, skv, causal).int()
        assert torch.equal(seen, want), walk


def test_schedule_walks_every_head():
    """The dK/dV walk takes each of the G grouped heads' tiles once."""
    for sq, skv, causal in WALKS:
        for group in (1, 3, 6):
            tiles = [(k0, g, p0, kw) for k0, g, p0, kw, _ in
                     _walk_dkdv(sq, skv, group, causal)]
            assert len(tiles) == len(set(tiles))
            by_head = [sorted((k0, p0, kw) for k0, g, p0, kw in tiles
                              if g == h) for h in range(group)]
            assert all(t == by_head[0] for t in by_head)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate(q, k, v, o, do, lse, causal):
    """The bf16 kernels' arithmetic along their schedule: q, o, do (B, H,
    Sq, D), k, v (B, KVH, Skv, D) f32 holding bf16 values, lse (B, H, Sq)
    f32. Returns (dq, dk, dv) rounded to bf16, in those layouts."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    scale = d ** -0.5
    scale_log2 = scale * LOG2E
    di = (do * o).sum(-1)                                 # (b, h, sq) f32

    def pad(x, n):  # rows past the matrix read as zeros, as TMA fills them
        return torch.nn.functional.pad(x, (0, 0, 0, n))

    qp, dop = pad(q, BLOCK), pad(do, BLOCK)
    kp, vp = pad(k, 2 * BLOCK), pad(v, 2 * BLOCK)
    lsep = torch.nn.functional.pad(lse, (0, BLOCK))
    dip = torch.nn.functional.pad(di, (0, BLOCK))
    dk = torch.zeros(b, kvh, skv + 2 * BLOCK, d)
    dv = torch.zeros_like(dk)
    for k0, g, p0, kw, masked in _walk_dkdv(sq, skv, group, causal):
        hq = [hk * group + g for hk in range(kvh)]
        kt, vt = kp[:, :, kw:kw + R], vp[:, :, kw:kw + R]
        qt, dot = qp[:, hq, p0:p0 + R], dop[:, hq, p0:p0 + R]
        st = kt @ qt.transpose(-1, -2)                    # S^T (keys, rows)
        pt = torch.exp2(st * scale_log2 - lsep[:, hq, None, p0:p0 + R] * LOG2E)
        pt = pt * _tile_mask(p0, kw, sq, skv, causal, masked).T.float()
        dv[:, :, kw:kw + R] += _bf16(pt) @ dot
        dpt = vt @ dot.transpose(-1, -2)
        dst = pt * (dpt - dip[:, hq, None, p0:p0 + R])
        dk[:, :, kw:kw + R] += _bf16(dst) @ qt
    dq = torch.zeros(b, h, sq + BLOCK, d)
    kv = [hq // group for hq in range(h)]
    for wrow, kt0, masked in _walk_dq(sq, skv, causal):
        qt, dot = qp[:, :, wrow:wrow + R], dop[:, :, wrow:wrow + R]
        kt, vt = kp[:, kv, kt0:kt0 + R], vp[:, kv, kt0:kt0 + R]
        s = qt @ kt.transpose(-1, -2)                     # (rows, keys)
        p = torch.exp2(s * scale_log2 - lsep[:, :, wrow:wrow + R, None] * LOG2E)
        p = p * _tile_mask(wrow, kt0, sq, skv, causal, masked).float()
        ds = p * (dot @ vt.transpose(-1, -2) - dip[:, :, wrow:wrow + R, None])
        dq[:, :, wrow:wrow + R] += _bf16(ds) @ kt
    return (_bf16(dq[:, :, :sq] * scale), _bf16(dk[:, :, :skv] * scale),
            _bf16(dv[:, :, :skv]))


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_jax_and_plain(case):
    b, sq, skv, h, kvh, d, causal = CASES[case]
    rng = np.random.default_rng(len(case))
    q, do = (_bf16(torch.from_numpy(
        rng.standard_normal((b, sq, h, d)).astype(np.float32)))
        for _ in range(2))
    k, v = (_bf16(torch.from_numpy(
        rng.standard_normal((b, skv, kvh, d)).astype(np.float32)))
        for _ in range(2))
    out, lse = ref.flash_attention_lse(q, k, v, causal=causal, chunk_kv=skv)
    t = (lambda x: x.transpose(1, 2).contiguous())
    got = _emulate(t(q), t(k), t(v), t(_bf16(out)), t(do), lse, causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_chunked(
        q_, k_, v_, causal=causal, chunk_kv=skv),
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want_jax = vjp(jnp.asarray(do.numpy()))
    want_plain = ref.flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=causal, block_kv=skv)
    for name, g, wj, wp in zip("qkv", got, want_jax, want_plain):
        g = g.transpose(1, 2)
        assert g.shape == wp.shape
        gj, gp = _gap(g, np.asarray(wj)), _gap(g, wp)
        assert gj <= BOUND and gp <= BOUND, (
            f"d{name}: {gj:.3e} from jax.vjp, {gp:.3e} from the plain "
            f"backward (bound {BOUND})")
        # the kernels round: the emulation is not the f32 answer itself
        assert gp > 0.0
