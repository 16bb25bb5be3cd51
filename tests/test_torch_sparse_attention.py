"""paddle_tpu_torch block-sparse attention and ``F.sparse_attention``
against ``paddle_tpu`` at the reference tests' size (``B, H, S, D = 1, 2,
256, 64``, blocks of 64; ``tests/test_block_sparse_attention.py``): the
mask builders and tables, the kernel's plain forward (``o`` and ``lse``)
against the Pallas kernel in interpret mode, the autograd Function's
gradients against ``jax.vjp`` of the reference's custom VJP, the CSR
pattern analysis and its dense fallback, the bf16 kernel's per-tile
walk tables (and a plain walk of them against the plain forward), and
a pre-norm sparse attention block (RMSNorm, a qkv projection, sparse_attention, an output
projection and the residual) built from each package's public layers on
shared weights.

Tolerances: f32 forward within 5e-5 (the reference's own limit); the
plain walk within 1e-6 of the plain forward (f32 sums grouped by stage
instead of by block);
gradients, the block's loss and its gradients within 1e-4 of each
tensor's largest magnitude (f32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.nn import functional as PF
from paddle_tpu.ops.pallas import block_sparse_attention as ref_bsa

from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.io import load_numpy_state_dict, numpy_grads
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import transformer
from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
from paddle_tpu_torch.ops.cuda import build

B, H, S, D = 1, 2, 256, 64
BLOCK = 64
NQ = S // BLOCK


def _qkv(seed, b=B, h=H, s=S, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _empty_row_mask():
    """Non-causal window with q-row 0 and k-column 3 empty: a padded step
    of dq meets row 0's lse (-1e30 ln2), and k-column 3's padded steps
    point at q-block 0."""
    bm = bsa.make_sliding_window_mask(NQ, NQ, 2, causal=False)
    bm[0, :] = False
    bm[:, 3] = False
    return bm


PATTERNS = {
    "window": lambda: bsa.make_sliding_window_mask(NQ, NQ, 2),
    "global_window": lambda: bsa.make_global_plus_window_mask(NQ, NQ, 2, 1),
    "empty_row": _empty_row_mask,
}


def _csr(bm, block, b, h):
    """The token-level CSR of a block mask, the same for every (b, h)."""
    tok = np.kron(bm, np.ones((block, block), bool))
    offs = np.concatenate([[0], np.cumsum(tok.sum(1))]).astype(np.int32)
    cols = np.nonzero(tok)[1].astype(np.int32)
    return (np.broadcast_to(offs, (b, h, len(offs))).copy(),
            np.broadcast_to(cols, (b, h, len(cols))).copy())


def _max_err(got, want):
    return np.abs(got.detach().float().numpy() - np.asarray(want)).max()


# ---------------------------------------------------------- host tables
@pytest.mark.parametrize("nq,nk,window,glob,causal", [
    (4, 4, 2, 1, True), (7, 5, 3, 2, True), (6, 6, 2, 1, False)])
def test_mask_builders_and_tables_equal_reference(nq, nk, window, glob,
                                                  causal):
    for mine, theirs in (
            (bsa.make_sliding_window_mask(nq, nk, window, causal),
             ref_bsa.make_sliding_window_mask(nq, nk, window, causal)),
            (bsa.make_global_plus_window_mask(nq, nk, window, glob, causal),
             ref_bsa.make_global_plus_window_mask(nq, nk, window, glob,
                                                  causal))):
        assert np.array_equal(mine, theirs)
        got = bsa.prepare_block_mask(mine, 64, 64)
        want = ref_bsa.prepare_block_mask(theirs, 64, 64)
        for a in ("kt", "counts", "qt", "qcounts"):
            assert np.array_equal(getattr(got, a), getattr(want, a)), a
        assert (got.max_active, got.qmax) == (want.max_active, want.qmax)
    with pytest.raises(ValueError, match="no active blocks"):
        bsa.block_mask_tables(np.zeros((2, 2), bool))


def _ragged_mask(nk):
    """5 q-blocks of 64 (300 tokens: a ragged last block, and a last tile
    with one mask row) over nk k-blocks: a non-causal window plus global
    k-block 0, q-row 1 empty."""
    bm = bsa.make_sliding_window_mask(5, nk, 2, causal=False)
    bm[:, 0] = True
    bm[1, :] = False
    return bm


# name -> (block mask, block_q, block_k, seq_q, seq_k)
WALK_CASES = {
    **{name: (make(), BLOCK, BLOCK, S, S) for name, make in PATTERNS.items()},
    "global_window_ragged": (PATTERNS["global_window"](), BLOCK, BLOCK, 200,
                             200),
    "empty_row_ragged_64_64": (_ragged_mask(5), 64, 64, 300, 300),
    "empty_row_ragged_64_128": (_ragged_mask(3), 64, 128, 300, 300),
    "global_window_128_64": (bsa.make_global_plus_window_mask(2, 4, 2, 1),
                             128, 64, S, S),
    "window_256_128": (bsa.make_sliding_window_mask(2, 4, 3, causal=False),
                       256, 128, 512, 512),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_tile_walk_tables_cover_each_row_in_kt_order(case):
    """Each warpgroup's boxes (flag bit set) are exactly its mask row's
    active k-blocks in kt's order, block_k / 64 boxes each, once; every
    box has a flag; a warpgroup past the last mask row holds none; the
    order puts the tiles with the most stages first."""
    bm, bq, bk, _sq, _sk = WALK_CASES[case]
    t = bsa.prepare_block_mask(bm, bq, bk)
    boxes, counts, order = t.boxes, t.box_counts, t.tile_order
    nq = bm.shape[0]
    per = bk // bsa.BOX_KEYS
    assert boxes.shape[0] == -(-nq * bq // bsa.TILE_ROWS) == len(counts)
    for tile in range(boxes.shape[0]):
        bx = boxes[tile, :counts[tile]]
        assert not boxes[tile, counts[tile]:].any()
        assert (bx & 3).all() and (np.diff(bx >> 2) > 0).all()
        for w in range(2):
            qi = (tile * bsa.TILE_ROWS + w * 64) // bq
            mine = bx[(bx >> w) & 1 == 1] >> 2
            if qi >= nq:
                assert len(mine) == 0
                continue
            want = (t.kt[qi, :t.counts[qi], None] * per
                    + np.arange(per)).ravel()
            assert np.array_equal(mine, want), (tile, w)
    stages = (counts + 1) // 2
    assert sorted(order) == list(range(len(counts)))
    assert (np.diff(stages[order]) <= 0).all()


def _walk_fwd(q, k, v, tables, scale):
    """The bf16 kernel's walk in plain PyTorch: tiles in ``tile_order``,
    each warpgroup's 64 rows through stages of two 64-key boxes (an odd
    count's missing box a copy of the first), the scores of a box the
    warpgroup does not hold, of the missing box and of keys past seq_k at
    -1e30, the base-2 online softmax a stage, p rounded to v's type."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    boxes, counts = tables.boxes, tables.box_counts
    n_keys = (int(boxes.max() >> 2) + 1) * bsa.BOX_KEYS
    pad = (0, 0, 0, max(0, n_keys - sk))
    qf = q.float().reshape(b * h, sq, d)
    kf = torch.nn.functional.pad(k.float().reshape(b * h, sk, d), pad)
    vf = torch.nn.functional.pad(v.float().reshape(b * h, sk, d), pad)
    o = torch.zeros(b * h, sq, d)
    lse = torch.zeros(b * h, sq)
    cols = torch.arange(bsa.BOX_KEYS)
    for tile in tables.tile_order:
        bx = [int(e) for e in boxes[tile, :counts[tile]]]
        for w in range(2):
            r0 = tile * bsa.TILE_ROWS + w * 64
            r1 = min(r0 + 64, sq)
            if r0 >= sq:
                continue
            m = torch.full((b * h, r1 - r0, 1), bsa._NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros(b * h, r1 - r0, d)
            for j in range(0, len(bx), 2):
                pair = bx[j:j + 2] if j + 1 < len(bx) else [bx[j], bx[j] >> 2 << 2]
                if not any((e >> w) & 1 for e in pair):
                    continue
                rows = torch.cat([(e >> 2) * bsa.BOX_KEYS + cols for e in pair])
                keep = torch.cat([((e >> w) & 1) & ((e >> 2) * bsa.BOX_KEYS + cols < sk)
                                  for e in pair]).bool()
                s = torch.matmul(qf[:, r0:r1], kf[:, rows].transpose(-1, -2))
                s = (s * (scale * bsa._LOG2E)).masked_fill(~keep, bsa._NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp2(s - m_new)
                corr = torch.exp2(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                                vf[:, rows])
                m = m_new
            l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
            o[:, r0:r1] = acc / l_safe
            lse[:, r0:r1] = (m * bsa._LN2 + torch.log(l_safe))[..., 0]
    return o.reshape(b, h, sq, d).to(q.dtype), lse


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_tile_walk_plain_matches_bsa_fwd_ref(case):
    """A plain walk of the tile tables in the kernel's order gives the
    plain forward's o and lse (itself held against the Pallas kernel by
    test_bsa_fwd_plain_matches_pallas_kernel), empty rows included."""
    bm, bq, bk, sq, sk = WALK_CASES[case]
    q = torch.tensor(_qkv(10, s=sq)[0])
    k, v = map(torch.tensor, _qkv(11, s=sk)[:2])
    tables = bsa.prepare_block_mask(bm, bq, bk)
    dev = tables.on("cpu")
    want_o, want_lse = bsa._bsa_fwd_ref(q, k, v, dev["kt"], dev["cnt"],
                                        D ** -0.5, bq, bk)
    o, lse = _walk_fwd(q, k, v, tables, D ** -0.5)
    assert (o - want_o).abs().max() <= 1e-6
    assert (lse - want_lse).abs().max() <= 1e-6


def test_tables_are_copied_once_per_pattern():
    bm = PATTERNS["window"]()
    t = bsa.prepare_block_mask(bm, BLOCK, BLOCK)
    assert bsa.prepare_block_mask(bm.copy(), BLOCK, BLOCK) is t
    assert t.on("cpu")["kt"] is t.on(torch.device("cpu"))["kt"]
    assert t.on("cpu")["kt"].dtype == torch.int32


# -------------------------------------------------------- plain forward
@pytest.mark.parametrize("pattern,s", [
    ("window", S), ("global_window", S), ("global_window", 200),
    ("empty_row", S)])
def test_bsa_fwd_plain_matches_pallas_kernel(pattern, s):
    """o and lse of the plain version against the Pallas kernel in
    interpret mode; s = 200 leaves a ragged last block of 8 keys."""
    q, k, v = _qkv(0, s=s)
    bm = PATTERNS[pattern]()
    tables = ref_bsa.prepare_block_mask(bm, BLOCK, BLOCK)
    want_o, want_lse = ref_bsa._bsa_fwd(
        *map(jnp.asarray, (q, k, v)), tables.kt_arr(), tables.cnt_arr(),
        D ** -0.5, BLOCK, BLOCK, True)
    o, lse = bsa.bsa_fwd(*map(torch.tensor, (q, k, v)),
                         bsa.prepare_block_mask(bm, BLOCK, BLOCK))
    assert o.shape == (B, H, s, D) and lse.shape == (B * H, s)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _max_err(o, want_o) < 5e-5
    want_lse = np.asarray(want_lse).reshape(B * H, s)
    rows = np.repeat(bm.any(1), BLOCK)[:s]
    assert _max_err(lse[:, rows], want_lse[:, rows]) < 5e-5
    if not rows.all():                  # a row with no active block
        assert bool((o[:, :, ~rows] == 0).all())
        assert np.array_equal(lse[:, ~rows].numpy(), want_lse[:, ~rows])


@pytest.mark.parametrize("pattern", ["window", "empty_row"])
def test_bsa_grads_match_jax(pattern):
    """The Function's backward (the PyTorch form of ``_bsa_bwd_rule``)
    against jax.vjp of the reference; the empty-row pattern has padded
    steps that meet an empty row's lse, which torch.where drops."""
    q, k, v = _qkv(1)
    g = _qkv(2)[0]
    bm = PATTERNS[pattern]()
    _, vjp = jax.vjp(lambda *t: ref_bsa.block_sparse_attention(
        *t, bm, BLOCK, BLOCK, interpret=True), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    out = bsa.block_sparse_attention(*leaves, bm, BLOCK, BLOCK)
    out.backward(torch.tensor(g))
    for t, w in zip(leaves, want):
        assert torch.isfinite(t.grad).all()
        assert _max_err(t.grad, w) <= 1e-4 * np.abs(np.asarray(w)).max()


def test_bsa_checks_and_cuda_route(monkeypatch, tmp_path):
    """A bad mask shape raises as in the reference; on the CUDA route a
    head_dim or block size the kernel does not take raises with its
    limit, and with no nvcc the launch raises, never reaching the plain
    version."""
    q, k, v = map(torch.tensor, _qkv(3))
    with pytest.raises(ValueError, match="block_mask shape"):
        bsa.block_sparse_attention(q, k, v, np.ones((2, 2), bool), BLOCK,
                                   BLOCK)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*a, **kw):
        raise AssertionError("plain version reached on the CUDA route")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(bsa, "_route", lambda *t: "cuda")
    monkeypatch.setattr(bsa, "_bsa_fwd_ref", plain_called)
    bm = PATTERNS["window"]()
    with pytest.raises(RuntimeError, match="nvcc"):
        bsa.bsa_fwd(q, k, v, bsa.prepare_block_mask(bm, BLOCK, BLOCK))
    with pytest.raises(ValueError, match=r"head_dim 32 .*\(64, 128\)"):
        bsa.bsa_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                    v[..., :32].contiguous(),
                    bsa.prepare_block_mask(bm, BLOCK, BLOCK))
    small = bsa.make_sliding_window_mask(S // 32, S // 32, 2)
    with pytest.raises(ValueError, match=r"block_q 32.*\(64, 128, 256, 512\)"):
        bsa.bsa_fwd(q, k, v, bsa.prepare_block_mask(small, 32, 32))
    assert bsa.LAUNCHES["bsa_fwd"] == 0


# ----------------------------------------------------- sparse_attention
def _analysis_cases():
    """CSRs [2, 2, ...] over 128 tokens: a block pattern; a ragged one
    (duplicate columns, an empty row); one whose (0, 1) lists the same
    mask in another order; one whose (1, 1) differs in one entry."""
    rng = np.random.default_rng(9)
    ql = 128
    offs, cols = _csr(bsa.make_global_plus_window_mask(4, 4, 2, 1), 32, 2, 2)
    counts = rng.integers(0, 6, ql)
    counts[7] = 0
    o = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    c = rng.integers(0, ql, o[-1]).astype(np.int32)
    c[1] = c[0]
    ragged = (np.broadcast_to(o, (2, 2, ql + 1)).copy(),
              np.broadcast_to(c, (2, 2, len(c))).copy())
    reordered = (offs.copy(), cols.copy())
    for r in range(ql):
        seg = slice(offs[0, 1, r], offs[0, 1, r + 1])
        reordered[1][0, 1, seg] = reordered[1][0, 1, seg][::-1]
    differing = (offs.copy(), cols.copy())
    differing[1][1, 1, 5] = (differing[1][1, 1, 5] + 1) % ql
    return [(offs, cols), ragged, reordered, differing]


@pytest.mark.parametrize("case", range(4))
def test_pattern_analysis_equals_reference_loops(case):
    """The vectorised CSR analysis against the reference's loops: the
    shared token mask (or its absence) and block alignment."""
    from paddle_tpu.nn.functional import transformer as ref_tr
    offs, cols = _analysis_cases()[case]
    want = ref_tr._csr_shared_mask(offs, cols, 128, 128)
    got = transformer._csr_shared_mask(offs, cols, 128, 128)
    assert (got is None) == (want is None) == (case == 3)
    if want is None:
        return
    assert np.array_equal(got, want)
    for block in (64, 32, 16):
        a = transformer._mask_block_aligned(got, 128, 128, block)
        b = ref_tr._mask_block_aligned(want, 128, 128, block)
        assert (a is None) == (b is None)
        assert a is None or np.array_equal(a, b)


def _torch_and_paddle(*arrays):
    return ([torch.tensor(a) for a in arrays],
            [P.to_tensor(a) for a in arrays])


def test_block_aligned_csr_takes_the_kernel_path(monkeypatch):
    transformer._block_mask_cache.clear()
    transformer._pattern_identity_memo.clear()
    q, k, v = _qkv(4)
    bm = PATTERNS["global_window"]()
    offs, cols = _csr(bm, BLOCK, B, H)
    (tq, tk, tv, to, tc), (pq, pk, pv, po, pc) = _torch_and_paddle(
        q, k, v, offs, cols)
    want = PF.sparse_attention(pq, pk, pv, po, pc).numpy()
    dense = []
    monkeypatch.setattr(transformer, "_sparse_attention_dense",
                        lambda *a: dense.append(a))
    hits = transformer.PATTERN_STATS["memo_hits"]
    for _ in range(2):
        got = F.sparse_attention(tq, tk, tv, to, tc)
        assert _max_err(got, want) < 5e-5
    assert not dense
    assert len(transformer._block_mask_cache) == 1
    (hit,) = transformer._block_mask_cache.values()
    assert hit[1] == BLOCK and np.array_equal(hit[0], bm)
    assert transformer.PATTERN_STATS["memo_hits"] == hits + 1
    to[0, 0, 1] += 0                     # in place: _version moves
    F.sparse_attention(tq, tk, tv, to, tc)
    assert transformer.PATTERN_STATS["memo_hits"] == hits + 1


def test_ragged_csr_takes_the_dense_path():
    transformer._block_mask_cache.clear()
    q, k, v = _qkv(5)
    rng = np.random.default_rng(0)
    cols_rows = [np.sort(rng.choice(S, 5, replace=False)) for _ in range(S)]
    offs = np.broadcast_to(np.arange(S + 1) * 5, (B, H, S + 1)).astype(
        np.int32).copy()
    cols = np.broadcast_to(np.concatenate(cols_rows), (B, H, 5 * S)).astype(
        np.int32).copy()
    offs[0, 1, 3:] -= 5                  # (0, 1): row 2 stores nothing
    (tq, tk, tv, to, tc), (pq, pk, pv, po, pc) = _torch_and_paddle(
        q, k, v, offs, cols)
    want = PF.sparse_attention(pq, pk, pv, po, pc).numpy()
    got = F.sparse_attention(tq, tk, tv, to, tc)
    assert list(transformer._block_mask_cache.values()) == [None]
    assert _max_err(got, want) < 5e-5
    assert bool((got[0, 1, 2] == 0).all())


def test_all_empty_pattern_stays_dense():
    transformer._block_mask_cache.clear()
    q, k, v = _qkv(6)
    offs = np.zeros((B, H, S + 1), np.int32)
    cols = np.zeros((B, H, 1), np.int32)
    got = F.sparse_attention(*map(torch.tensor, (q, k, v, offs, cols)))
    assert list(transformer._block_mask_cache.values()) == [None]
    assert bool((got == 0).all())


def test_masks_take_the_dense_path_as_the_reference(monkeypatch):
    """With either mask given both packages skip the block-sparse kernel
    and take their dense CSR path, which reads neither mask: the port
    equals the reference (within 5e-5, f32) and launches no kernel,
    even on a block-aligned pattern the kernel would take."""
    transformer._block_mask_cache.clear()
    transformer._pattern_identity_memo.clear()
    q, k, v = _qkv(7)
    offs, cols = _csr(PATTERNS["window"](), BLOCK, B, H)
    (tq, tk, tv, to, tc), (pq, pk, pv, po, pc) = _torch_and_paddle(
        q, k, v, offs, cols)
    unmasked = F.sparse_attention(tq, tk, tv, to, tc)    # the kernel path
    kernel = []
    monkeypatch.setattr(transformer, "block_sparse_flash_attention",
                        lambda *a, **kw: kernel.append(a))
    pad = np.ones((B, S), np.float32)
    pad[:, S // 2:] = 0.0
    causal = np.tril(np.ones((S, S), np.float32))
    for name, mask in (("key_padding_mask", pad), ("attn_mask", causal)):
        want = PF.sparse_attention(pq, pk, pv, po, pc,
                                   **{name: P.to_tensor(mask)}).numpy()
        got = F.sparse_attention(tq, tk, tv, to, tc,
                                 **{name: torch.tensor(mask)})
        assert _max_err(got, want) < 5e-5, name
        assert _max_err(unmasked, want) < 5e-5, name   # the mask is unread
    assert not kernel


# ------------------------------------------------------- the whole slice
HIDDEN, HEADS, HEAD_DIM, BATCH = 128, 2, 64, 2


class _PortBlock(torch.nn.Module):
    """x -> RMSNorm -> qkv -> sparse_attention -> out -> + x."""

    def __init__(self):
        super().__init__()
        self.norm = nn.RMSNorm(HIDDEN)
        self.qkv = nn.Linear(HIDDEN, 3 * HIDDEN)
        self.out = nn.Linear(HIDDEN, HIDDEN)

    def forward(self, x, offs, cols):
        b, s, _ = x.shape
        qkv = self.qkv(self.norm(x)).reshape(b, s, 3, HEADS, HEAD_DIM)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.sparse_attention(q, k, v, offs, cols)
        return self.out(o.transpose(1, 2).reshape(b, s, HIDDEN)) + x


class _RefBlock(P.nn.Layer):
    def __init__(self):
        super().__init__()
        self.norm = P.nn.RMSNorm(HIDDEN)
        self.qkv = P.nn.Linear(HIDDEN, 3 * HIDDEN)
        self.out = P.nn.Linear(HIDDEN, HIDDEN)

    def forward(self, x, offs, cols):
        b, s, _ = x.shape
        qkv = P.reshape(self.qkv(self.norm(x)), [b, s, 3, HEADS, HEAD_DIM])
        qkv = P.transpose(qkv, [2, 0, 3, 1, 4])
        o = PF.sparse_attention(qkv[0], qkv[1], qkv[2], offs, cols)
        o = P.reshape(P.transpose(o, [0, 2, 1, 3]), [b, s, HIDDEN])
        return self.out(o) + x


def test_sparse_block_matches_reference():
    """The slice as a whole: loss and every gradient of the block, the
    port's and the reference's, from the same f32 weights and inputs."""
    rng = np.random.default_rng(8)
    P.seed(0)
    ref = _RefBlock()
    ref.norm.weight.set_value(
        (1.0 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32))
    state = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    x = rng.standard_normal((BATCH, S, HIDDEN)).astype(np.float32)
    target = rng.standard_normal((BATCH, S, HIDDEN)).astype(np.float32)
    offs, cols = _csr(PATTERNS["global_window"](), BLOCK, BATCH, HEADS)

    y = ref(P.to_tensor(x), P.to_tensor(offs), P.to_tensor(cols))
    diff = y - P.to_tensor(target)
    want_loss = (diff * diff).mean()
    want_loss.backward()
    want = {n: np.asarray(p.grad._value) for n, p in ref.named_parameters()}

    block = _PortBlock()
    load_numpy_state_dict(block, state)
    transformer._block_mask_cache.clear()
    y = block(torch.tensor(x), torch.tensor(offs), torch.tensor(cols))
    loss = ((y - torch.tensor(target)) ** 2).mean()
    loss.backward()
    (hit,) = transformer._block_mask_cache.values()
    assert hit is not None and hit[1] == BLOCK
    assert abs(loss.item() - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    grads = numpy_grads(block)
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        err = np.abs(grads[name] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)
