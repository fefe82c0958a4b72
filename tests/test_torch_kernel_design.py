"""The arithmetic of the Hopper designs of K4, K3, K5 and K1, emulated on
the CPU.

The CUDA kernels run only on the card; what their designs change in
the numbers is pinned down here, against the JAX package's kernels:

* K4 (``csrc/flash_attention.cu``, bf16 inputs): tiles of 64 keys, an
  online softmax in fp32 in the log2 domain, and the probabilities
  rounded to bf16 before the P.V product (the Pallas kernel keeps P in
  fp32).  Held against the Pallas kernel in interpret mode at
  ``tests/test_kernels.py``'s bf16 shapes and at ragged S, within that
  file's bf16 tolerance of 2e-2.  Query row i sits at position
  q_offset + i over Sk keys (Sq != Sk for cross-attention).  With a
  window W, the walk of a q tile whose first row is at position p0
  starts at the key tile holding key p0 - W + 1; causal, it ends at the
  key of the tile's last row below Sq; a tile takes the masked path when
  it crosses the causal diagonal, the window's lower edge of one of a
  warp's rows or the keys' ragged end.  The walk is checked to cover
  every visible key and no tile that no row sees, the predicate to be
  true wherever a key of the (warp, tile) is masked, over Sq = Sk with
  and without a window and over Sq != Sk with offsets; the windowed and
  the cross / offset emulations are held against JAX's
  ``dense_attention`` (the Pallas kernel has neither) within 2e-2.
* K4's backward (``csrc/flash_attention_bwd.cu``, bf16): a dQ pass
  over 64-row q tiles and a dK/dV pass over blocks of 128 keys (two
  64-key warpgroups) or, at hd 256, of one 64-key slice whose two
  warpgroups each own half of hd's columns of dK and dV and both
  recompute S^T and dP^T, walked through a ring of 2 stages; P and dS
  rounded to bf16 before their products.  The walks and skip
  predicates are checked to cover every visible pair, and the
  emulations held against ``flash_attention_bwd_plain`` within the
  card's tolerances (3e-2 of max(1, |want|), 1e-2 of a gradient row's
  L2 norm).
* K3 (``csrc/paged_attention.cu``): the window's valid pages split into
  per-block slices of a cluster of 1/2/4/8 blocks, each slice split
  again over the block's lane groups (chunks of 4 tokens); every part
  keeps a (max, sum, acc) state, and the states merge by rescaling to
  the largest max.  Held against ``decode_paged`` (the JAX reference
  and the Pallas kernel in interpret mode) within 2e-5 in fp32.
* K5 (``csrc/ssd_intra.cu``): 3xTF32 on the tensor cores.  Each operand
  x is split as big = tf32(x), small = tf32(x - big), rounded as
  ``cvt.rna.tf32.f32`` rounds (half away from zero on the 13 dropped
  bits); keys go in steps of 8 in order, the diagonal masked by select,
  and each step adds small.big, big.small, then big.big to an fp32 sum.
  Held against the Pallas kernel in interpret mode at
  ``tests/test_kernels.py``'s fp32 shapes within that file's 2e-4, and,
  with ``chip_smoke.check_ssd``'s steep cumsum, against the function in
  float64 within 1e-5 of the output's scale and against
  ``ssd_intra_plain`` within 2e-4 of it (one TF32 product, which the
  2e-4 check would not pass, is shown beside it).
* K1 (``csrc/latch_ops.cu``): lines partitioned into slices, one block
  each; a block finds each line's first request (the least index) and
  walks the line's chain from it in request order.  Held bit for bit
  against the JAX ``apply_batch`` through the Pallas kernel in
  interpret mode, with slices of 64 lines so that a small N spans
  several.
* K2 (``csrc/gcl_fetch.cu``): one launch of two kinds of block.  Merge
  blocks own slices of pages; each ORs the bits of the requests naming
  its slice, a pass of NT requests at a time, into a table and writes
  words | table.  Copy blocks own (request, chunk of NT x U 16-byte
  vectors) tiles, a valid row copied and an empty one zeroed, and the
  chunk-0 tile writes the request's old lanes and verdict from words.
  Every output element must be written by exactly one tile.  Held bit
  for bit against the Pallas kernel in interpret mode (distinct pages,
  or duplicates with equal bits) and against ``gcl_fetch_plain`` with
  duplicates of unequal bits, at slices, passes and chunks small enough
  that P, R and each row span several.

None of the emulations is on any path of the port: they are the
kernels' algorithms written out in PyTorch, for this file alone.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.ops import \
    attention as jax_flash  # noqa: E402
from repro.models.attention import dense_attention  # noqa: E402
from repro.kernels.gcl_fetch.ops import fetch as jax_fetch  # noqa: E402
from repro.kernels.latch_ops.ops import \
    apply_batch as jax_apply_batch  # noqa: E402
from repro.kernels.paged_attention.ops import \
    decode_paged as jax_decode_paged  # noqa: E402
from repro.kernels.ssd_intra.ops import \
    intra_chunk as jax_intra_chunk  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd_plain, flash_attention_plain  # noqa: E402
from repro_torch.kernels.gcl_fetch import WRITER_MASK_HI, \
    gcl_fetch_plain  # noqa: E402
from repro_torch.kernels.paged_attention import \
    cluster_size  # noqa: E402
from repro_torch.kernels.ssd_intra import ssd_intra_bwd_plain, \
    ssd_intra_plain  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


K4_TILE = 64              # keys per tile of the bf16 kernel
K4_ROWS = 64              # q rows per block of the bf16 kernel
K4_WARP_ROWS = 16         # q rows per warp
K3_LANE_GROUPS = 16       # lane groups of a block (bf16 rows at hd 128)
K3_TOKENS = 4             # tokens a lane group has in flight
NEG = -1e30


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------------ K4

def k4_walk(q0, sq, sk, causal, window, q_offset=0):
    """The key tiles the bf16 K4 walks for the q tile at row q0
    (``csrc/flash_attention.cu``: p0, k_begin, k_end, n_tiles; the
    kernel's WND is whether a window is given, its XQ whether Sq != Sk
    or q_offset > 0: without XQ it bounds a causal walk by min(S, q0 +
    64), the same bound as this one's when Sq = Sk at offset 0)."""
    p0 = q_offset + q0
    k_end = min(sk, p0 + min(K4_ROWS, sq - q0)) if causal else sk
    k_begin = max(0, p0 - window + 1) // K4_TILE * K4_TILE if window else 0
    return list(range(k_begin, k_end, K4_TILE))


def k4_masked_path(k0, p0, wrow, sk, causal, window):
    """The kernel's branch to the masked softmax for the warp whose rows
    start at position p0 + wrow and the key tile at k0."""
    return (k0 + K4_TILE > sk or (causal and k0 + K4_TILE - 1 > p0 + wrow)
            or bool(window)
            and k0 <= p0 + wrow + K4_WARP_ROWS - 1 - window)


def _visible(rows, keys, s, causal, window):
    """Which of ``keys`` the query positions ``rows`` see, of s keys."""
    ok = (keys[None, :] < s) & np.ones((len(rows), 1), bool)
    if causal:
        ok = ok & (keys[None, :] <= rows[:, None])
    if window:
        ok = ok & (keys[None, :] > rows[:, None] - window)
    return ok


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,window", [
    (64, 1), (500, 1), (500, 37), (500, 64), (500, 65), (500, 171),
    (500, 500), (500, None), (4096, 2048), (2304, 2048), (17, 3),
    (1000, 999), (640, 128)])
def test_k4_window_walk_and_mask_predicate(s, window, causal):
    """For every q tile: the walk covers every key a row of the tile
    sees, visits no tile in which no row sees a key, and the masked-path
    predicate holds wherever a (warp rows, tile) block has a masked
    element (the unmasked path would read it)."""
    _check_walk(s, s, 0, causal, window)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (1, 128, 0, None), (1, 128, 127, None), (17, 128, 0, None),
    (512, 128, 0, None), (512, 128, 37, None), (17, 500, 37, None),
    (512, 500, 37, None), (1, 500, 499, None), (17, 128, 100, 30),
    (64, 300, 200, 150), (1, 128, 200, 80), (512, 1664, 1152, None),
    (100, 1000, 900, 64), (70, 200, 10, 1)])
def test_k4_walk_with_offset_and_unequal_lengths(sq, sk, q_offset, window,
                                                 causal):
    """The walk and the masked-path predicate with Sq != Sk and query
    row i at position q_offset + i (cross-attention, its Sq 1 decode
    step, an offset suffix of a longer key range), with and without a
    window: no visible key is skipped, no tile that no row below Sq sees
    is visited, and every masked element takes the masked path.  The
    cases with a window sit where every row still sees a key, which the
    wrapper requires."""
    _check_walk(sq, sk, q_offset, causal, window)


def _check_walk(sq, sk, q_offset, causal, window):
    for q0 in range(0, sq, K4_ROWS):
        p0 = q_offset + q0
        rows = p0 + np.arange(min(K4_ROWS, sq - q0))
        walk = k4_walk(q0, sq, sk, causal, window, q_offset)
        seen = _visible(rows, np.arange(sk), sk, causal, window)
        assert seen.any(1).all(), q0                # every row sees a key
        need = {k // K4_TILE * K4_TILE for k in np.nonzero(seen.any(0))[0]}
        assert need == set(walk), (q0, sorted(need), walk)
        for k0 in walk:
            keys = np.arange(k0, k0 + K4_TILE)
            for wrow in range(0, K4_ROWS, K4_WARP_ROWS):
                idx = q0 + wrow + np.arange(K4_WARP_ROWS)
                masked = ~_visible(q_offset + idx, keys, sk, causal, window)
                masked &= (idx < sq)[:, None]    # rows past Sq never stored
                if masked.any():
                    assert k4_masked_path(k0, p0, wrow, sk, causal,
                                          window), (q0, k0, wrow)


def k4_emulate(q, k, v, *, causal, p_bf16=True, window=None, q_offset=0):
    """The bf16 K4's arithmetic on q [B, H, Sq, hd] and k, v
    [B, Hkv, Sk, hd] tensors, query row i at position q_offset + i:
    fp32 scores of the inputs, scaled into the log2 domain, an online
    softmax over 64-key tiles (a masked probability selected to 0), P
    rounded to bf16 when ``p_bf16``, fp32 sums.  Returns the fp32 output
    before the kernel's final cast.  The kernel skips tiles above the
    causal diagonal and below the window; here every row walks from the
    first tile any q tile walks (``k4_walk``), and a tile visited fully
    masked changes nothing (max unchanged, probabilities 0)."""
    b, hq, sq, hd = q.shape
    sk = k.shape[2]
    g = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    rows = q_offset + torch.arange(sq)[:, None]
    m = torch.full((b, hq, sq, 1), NEG)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, hd))
    first = min(k4_walk(q0, sq, sk, causal, window, q_offset)[0]
                for q0 in range(0, sq, K4_ROWS))
    for k0 in range(first, sk, K4_TILE):
        keys = torch.arange(k0, min(k0 + K4_TILE, sk))[None, :]
        x = qf @ kf[:, :, k0:k0 + K4_TILE].transpose(-1, -2) * scale_log2
        ok = keys <= rows if causal else torch.ones_like(keys, dtype=bool)
        if window:
            ok = ok & (keys > rows - window)
        x = torch.where(ok, x, NEG)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(x - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        if p_bf16:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr + p @ vf[:, :, k0:k0 + K4_TILE]
        m = m_new
    return acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", [
    (1, 256, 8, 4, 64, True),          # tests/test_kernels.py's bf16 case
    (1, 256, 4, 2, 128, True),
    (2, 256, 4, 1, 128, False),
    (1, 100, 4, 2, 64, True),          # ragged: 64 + 36 keys
    (1, 127, 4, 1, 128, False),
    (2, 17, 16, 1, 64, True),          # one partial tile, a group of 16
])
def test_k4_design_matches_pallas(b, s, hq, hkv, hd, causal):
    rng = np.random.default_rng(s + hd)
    q, k, v = [jnp.asarray(rng.normal(size=(b, s, h, hd)), jnp.bfloat16)
               for h in (hq, hkv, hkv)]
    want = jax_flash(q, k, v, causal=causal, backend="pallas",
                     interpret=True, block_q=128, block_k=128)
    got = k4_emulate(*[_t(a).transpose(1, 2) for a in (q, k, v)],
                     causal=causal).to(torch.bfloat16)
    err = np.abs(got.transpose(1, 2).float().numpy()
                 - np.asarray(want, np.float32)).max()
    assert err < 2e-2


@pytest.mark.parametrize("s,window,hd,g", [(256, 1, 64, 1), (256, 70, 128, 10),
                                           (300, 128, 256, 10),
                                           (100, 400, 64, 2)])
def test_k4_window_design_matches_dense_attention(s, window, hd, g):
    """The windowed bf16 K4 (tiles below a q tile's window skipped, the
    window's edge masked, P rounded to bf16) against JAX's
    ``dense_attention`` with the window, on bf16 inputs: within 2e-2 of
    max(1, |want|)."""
    rng = np.random.default_rng(s + window)
    q, k, v = [jnp.asarray(rng.normal(size=(1, s, h, hd)), jnp.bfloat16)
               for h in (g, 1, 1)]
    want = np.asarray(dense_attention(q, k, v, causal=True, window=window),
                      np.float32)
    got = k4_emulate(*[_t(a).transpose(1, 2) for a in (q, k, v)],
                     causal=True, window=window).to(torch.bfloat16)
    got = got.transpose(1, 2).float().numpy()
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() < 2e-2


@pytest.mark.parametrize("sq,sk,kw", [
    (512, 128, {"causal": False}),     # seamless's cross-attention
    (1, 128, {"causal": False}),       # ... and its decode step
    (17, 200, {"q_offset": 150}),
    (100, 300, {"q_offset": 180, "window": 70}),
])
def test_k4_cross_and_offset_design_matches_dense_attention(sq, sk, kw):
    """The bf16 K4 with Sq != Sk and a query offset against JAX's
    ``dense_attention`` (the model's own route for them) on bf16 inputs,
    hd 64, 16 q heads over 16 kv heads: within 2e-2 of max(1, |want|)."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = [jnp.asarray(rng.normal(size=(1, n, 16, 64)), jnp.bfloat16)
               for n in (sq, sk, sk)]
    want = np.asarray(dense_attention(q, k, v, **kw), np.float32)
    got = k4_emulate(*[_t(a).transpose(1, 2) for a in (q, k, v)],
                     causal=kw.get("causal", True), window=kw.get("window"),
                     q_offset=kw.get("q_offset", 0)).to(torch.bfloat16)
    got = got.transpose(1, 2).float().numpy()
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() < 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_k4_design_rounds_only_p(causal):
    """With P kept in fp32 the tiling and the log2-domain softmax give
    the plain version's fp32 result (2e-5); rounding P to bf16 is the
    one deliberate difference, and it stays inside the bf16 2e-2."""
    rng = np.random.default_rng(3)
    q, k, v = [torch.from_numpy(rng.normal(size=(2, h, 200, 64))
                                .astype(np.float32)).to(torch.bfloat16)
               for h in (4, 2, 2)]
    exact = flash_attention_plain(q.float(), k.float(), v.float(),
                                  causal=causal)
    fp32_p = k4_emulate(q, k, v, causal=causal, p_bf16=False)
    bf16_p = k4_emulate(q, k, v, causal=causal)
    assert (fp32_p - exact).abs().max().item() < 2e-5
    diff = (bf16_p - exact).abs().max().item()
    assert 0.0 < diff < 2e-2


# ------------------------------------------------------- K4's backward

K4B_KEYS = 128            # keys of a dK/dV block (two warpgroups of 64)
K4B_ROWS = 64             # q rows of a tile (a dQ block; a dK/dV step)
# hd 256 (``KvShape<256>``): a dK/dV block is one 64-key slice, whose two
# warpgroups each own 128 of the 256 columns of dK and dV and both
# compute S^T and dP^T; 2 Q/dO/lse/D stages in flight
K4B_HD256 = {"keys": 64, "split": 2, "stages": 2}


def k4_bwd_query_tiles(k0, sq, causal, window, q_offset, keys=K4B_KEYS):
    """The q tiles the dK/dV block of keys [k0, k0 + keys) walks, for
    each q head of its group (``csrc/flash_attention_bwd.cu``:
    ``query_range``): from the tile of the first row whose position
    reaches k0 when causal, up to the last row whose window still holds
    the block's last key."""
    ib = max(0, k0 - q_offset) // K4B_ROWS * K4B_ROWS if causal else 0
    ie = (min(sq, k0 + keys - 1 + window - q_offset) if window
          else sq)
    return list(range(ib, ie, K4B_ROWS))


def k4_bwd_skip(kg, i0, sq, sk, causal, window, q_offset):
    """A warpgroup whose 64 keys start at kg skips the tile at i0."""
    p0 = q_offset + i0
    p_last = p0 + min(K4B_ROWS, sq - i0) - 1
    return (kg >= sk or (causal and kg > p_last)
            or bool(window) and kg + K4B_ROWS - 1 <= p0 - window)


def k4_bwd_edge(kw, i0, sq, sk, causal, window, q_offset):
    """The warp whose 16 keys start at kw evaluates the mask on the tile
    at i0 (dK/dV pass)."""
    p0 = q_offset + i0
    return (i0 + K4B_ROWS > sq or kw + 16 > sk or (causal and kw + 15 > p0)
            or bool(window) and kw <= p0 + K4B_ROWS - 1 - window)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (512, 512, 0, None), (300, 300, 0, 70), (1024, 1024, 0, 256),
    (130, 77, 0, None), (100, 260, 160, None), (512, 1664, 1152, None),
    (1, 128, 0, None), (200, 300, 100, 150), (64, 64, 0, 1)])
def test_k4_bwd_walk_skip_and_mask_predicate(sq, sk, q_offset, window,
                                            causal):
    """Every visible (row, key) pair lies in a q tile that its key's
    dK/dV block walks, and each walked tile holds one; a warpgroup that
    skips a tile sees no pair of it; a warp that takes the unmasked path
    sees every pair of its keys and the tile's rows."""
    if window is not None and q_offset + sq - window >= sk:
        pytest.skip("a row would see no key (the wrapper refuses it)")
    _check_bwd_walk(sq, sk, q_offset, window, causal, K4B_KEYS)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (512, 512, 0, 2048), (300, 300, 0, 70), (4096, 4096, 0, 2048),
    (130, 77, 0, None), (100, 260, 160, None), (1, 128, 0, None),
    (200, 300, 100, 150), (64, 64, 0, 1)])
def test_k4_bwd_hd256_walk_skip_and_mask_predicate(sq, sk, q_offset, window,
                                                   causal):
    """The same walk, skip and mask properties with hd 256's dK/dV blocks
    of one 64-key slice (recurrentgemma-2b's 2048 window at S 512, where
    it does not bite, and at 4096, where it does)."""
    if window is not None and q_offset + sq - window >= sk:
        pytest.skip("a row would see no key (the wrapper refuses it)")
    _check_bwd_walk(sq, sk, q_offset, window, causal, K4B_HD256["keys"])


def _check_bwd_walk(sq, sk, q_offset, window, causal, keys):
    rows = q_offset + np.arange(sq)
    vis = _visible(rows, np.arange(sk), sk, causal, window)   # [Sq, Sk]
    for k0 in range(0, sk, keys):
        tiles = k4_bwd_query_tiles(k0, sq, causal, window, q_offset, keys)
        seen = np.zeros(sq, bool)
        for i0 in tiles:
            seen[i0:i0 + K4B_ROWS] = True
            assert vis[i0:i0 + K4B_ROWS, k0:k0 + keys].any(), (k0, i0)
            for kg in range(k0, k0 + keys, K4B_ROWS):
                block = vis[i0:i0 + K4B_ROWS, kg:kg + K4B_ROWS]
                if k4_bwd_skip(kg, i0, sq, sk, causal, window, q_offset):
                    assert not block.any(), (kg, i0)
                for kw in range(kg, kg + K4B_ROWS, 16):
                    if not k4_bwd_edge(kw, i0, sq, sk, causal, window,
                                       q_offset):
                        assert vis[i0:i0 + K4B_ROWS, kw:kw + 16].all()
        need = vis[:, k0:k0 + keys].any(1)
        assert not (need & ~seen).any(), k0


def k4_bwd_emulate(q, k, v, out, lse, dout, *, causal, window=None,
                   q_offset=0, bf16_points=True):
    """The bf16 K4 backward's arithmetic (fp32 before the outputs' cast):
    pass 1 over 64-row q tiles and their walk of 64-key tiles (``k4_walk``
    at the dQ block's 64 rows), pass 2 over 128-key blocks, each q head
    of the group in order and the tiles of ``k4_bwd_query_tiles``, a
    warpgroup of 64 keys skipping the tiles it shares no visible pair
    with.  Scores and sums in fp32 from the bf16 inputs, P = exp2(s
    scale log2 e - lse log2 e) with masked pairs selected to 0, and, when
    ``bf16_points``, P rounded to bf16 before dV += P^T dO and dS before
    dK += dS^T Q and dQ += dS K."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16_points \
        else (lambda x: x)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    sl2 = math.log2(math.e) / math.sqrt(hd)
    l2 = lse.float() * math.log2(math.e)
    dsum = (dof * out.float()).sum(-1)
    vis = torch.from_numpy(_visible(q_offset + np.arange(sq), np.arange(sk),
                                    sk, causal, window))

    def p_ds(heads, rows, keys, kt, vt):
        s = qf[:, heads][:, :, rows] @ kt.transpose(-1, -2)
        p = torch.exp2(s * sl2 - l2[:, heads][:, :, rows, None])
        p = torch.where(vis[rows][:, keys], p, 0.0)
        dp = dof[:, heads][:, :, rows] @ vt.transpose(-1, -2)
        return p, p * (dp - dsum[:, heads][:, :, rows, None])

    dq = torch.zeros(b, hq, sq, hd)
    for q0 in range(0, sq, K4B_ROWS):
        rows = torch.arange(q0, min(q0 + K4B_ROWS, sq))
        for k0 in k4_walk(q0, sq, sk, causal, window, q_offset):
            keys = torch.arange(k0, min(k0 + 64, sk))
            kt = kf[:, :, keys].repeat_interleave(g, 1)
            vt = vf[:, :, keys].repeat_interleave(g, 1)
            _, ds = p_ds(torch.arange(hq), rows, keys, kt, vt)
            dq[:, :, rows] += rnd(ds) @ kt
    if hd == 256:
        dk, dv = k4_bwd_hd256_dkdv(qf, kf, vf, dof, p_ds, rnd, sq, causal,
                                   window, q_offset)
        scale = 1.0 / math.sqrt(hd)
        return dq * scale, dk * scale, dv
    dk = torch.zeros(b, hkv, sk, hd)
    dv = torch.zeros(b, hkv, sk, hd)
    for k0 in range(0, sk, K4B_KEYS):
        for j in range(g):
            heads = torch.arange(hkv) * g + j
            for i0 in k4_bwd_query_tiles(k0, sq, causal, window, q_offset):
                rows = torch.arange(i0, min(i0 + K4B_ROWS, sq))
                qt, dot = qf[:, heads][:, :, rows], dof[:, heads][:, :, rows]
                for kg in range(k0, min(k0 + K4B_KEYS, sk), K4B_ROWS):
                    if k4_bwd_skip(kg, i0, sq, sk, causal, window, q_offset):
                        continue
                    keys = torch.arange(kg, min(kg + K4B_ROWS, sk))
                    p, ds = p_ds(heads, rows, keys, kf[:, :, keys],
                                 vf[:, :, keys])
                    dv[:, :, keys] += rnd(p).transpose(-1, -2) @ dot
                    dk[:, :, keys] += rnd(ds).transpose(-1, -2) @ qt
    scale = 1.0 / math.sqrt(hd)
    return dq * scale, dk * scale, dv


def k4_bwd_hd256_dkdv(qf, kf, vf, dof, p_ds, rnd, sq, causal, window,
                      q_offset):
    """hd 256's dK/dV pass as ``flash_attention_bwd_dkdv_kernel<256>``
    runs it: a block owns one 64-key slice of a (batch, kv head); its
    producer walks steps j of the group's heads and the slice's q tiles
    (head ``kh * g + j // n_qt``, tile ``ib + (j % n_qt) * 64``) into a
    ring of 2 stages, and each of the two consumer warpgroups takes every
    step from its stage, skips it by the slice's predicate, computes S^T
    and dP^T over the whole hd itself, and adds P^T dO and dS^T Q to its
    own 128 columns of dV and dK."""
    b, hkv, sk, hd = kf.shape
    g = qf.shape[1] // hkv
    keys_n, split = K4B_HD256["keys"], K4B_HD256["split"]
    nc = hd // split
    dk = torch.zeros(b, hkv, sk, hd)
    dv = torch.zeros(b, hkv, sk, hd)
    for kh in range(hkv):
        for k0 in range(0, sk, keys_n):
            tiles = k4_bwd_query_tiles(k0, sq, causal, window, q_offset,
                                       keys_n)
            n_qt = len(tiles)
            ring = [None] * K4B_HD256["stages"]
            keys = torch.arange(k0, min(k0 + keys_n, sk))
            for j in range(g * n_qt):
                h = kh * g + j // n_qt
                i0 = tiles[0] + (j % n_qt) * K4B_ROWS
                ring[j % len(ring)] = (h, i0)      # the producer's copy
                for wg in range(split):            # the consumer warpgroups
                    h, i0 = ring[j % len(ring)]
                    if k4_bwd_skip(k0, i0, sq, sk, causal, window,
                                   q_offset):
                        continue
                    rows = torch.arange(i0, min(i0 + K4B_ROWS, sq))
                    hs = torch.tensor([h])
                    p, ds = p_ds(hs, rows, keys, kf[:, kh:kh + 1, keys],
                                 vf[:, kh:kh + 1, keys])
                    cols = slice(wg * nc, (wg + 1) * nc)
                    dv[:, kh, keys, cols] += (
                        rnd(p).transpose(-1, -2)
                        @ dof[:, hs][:, :, rows][..., cols])[:, 0]
                    dk[:, kh, keys, cols] += (
                        rnd(ds).transpose(-1, -2)
                        @ qf[:, hs][:, :, rows][..., cols])[:, 0]
    return dk, dv


def _bwd_inputs(seed, b, sq, sk, hq, hkv, hd, **mask):
    rng = np.random.default_rng(seed)
    q, k, v, dout = [torch.from_numpy(rng.normal(size=(b, h, n, hd))
                                      .astype(np.float32))
                     .to(torch.bfloat16)
                     for n, h in ((sq, hq), (sk, hkv), (sk, hkv), (sq, hq))]
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **mask)
    return q, k, v, out, lse, dout


def _row_rel(got, want):
    """Largest error of a gradient row over its L2 norm, floored at a
    tenth of the tensor's RMS row norm (``chip_smoke.grad_row_rel``)."""
    out = 0.0
    for g, w in zip(got, want):
        norm = torch.linalg.vector_norm(w.float(), dim=-1)
        floor = 0.1 * float(norm.square().mean().sqrt())
        err = torch.linalg.vector_norm(g.float() - w.float(), dim=-1)
        out = max(out, float((err / norm.clamp(min=max(floor, 1e-30)))
                             .max()))
    return out


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,mask", [
    (2, 200, 200, 4, 2, 64, {"causal": True}),
    (1, 130, 77, 8, 1, 128, {"causal": False}),         # ragged, G 8
    (1, 300, 300, 4, 4, 64, {"causal": True, "window": 70}),
    (1, 100, 260, 16, 2, 64, {"causal": True, "q_offset": 160}),
    (2, 1, 128, 4, 2, 64, {"causal": False}),            # a decode row
])
def test_k4_bwd_design_matches_plain(b, sq, sk, hq, hkv, hd, mask):
    """The bf16 K4 backward's design against ``flash_attention_bwd_plain``
    on the same bf16 inputs and the forward's log-sum-exp: within
    ``chip_smoke.BWD_TOL`` (3e-2 of max(1, |want|)) and each gradient row
    within ``BWD_ROW_TOL`` (1e-2 of its L2 norm), the tolerances the card
    holds the kernel to; the error is the bf16 rounding of P and dS
    alone."""
    ins = _bwd_inputs(sq + sk + hq, b, sq, sk, hq, hkv, hd, **mask)
    want = flash_attention_bwd_plain(*[t.float() for t in ins], **mask)
    got = k4_bwd_emulate(*ins, causal=mask.get("causal", True),
                         window=mask.get("window"),
                         q_offset=mask.get("q_offset", 0))
    rel = max(float((g - w).abs().max() / max(1.0, float(w.abs().max())))
              for g, w in zip(got, want))
    assert rel < 3e-2
    assert _row_rel(got, want) < 1e-2


@pytest.mark.parametrize("b,sq,sk,hq,hkv,mask", [
    (1, 200, 200, 10, 1, {"causal": True}),       # recurrentgemma's heads
    (1, 300, 300, 10, 1, {"causal": True, "window": 70}),
    (2, 130, 77, 2, 2, {"causal": False}),        # Sq != Sk, ragged
    (1, 100, 260, 4, 2, {"causal": True, "q_offset": 160}),
    (1, 150, 330, 10, 1, {"causal": True, "q_offset": 180, "window": 90}),
])
def test_k4_bwd_hd256_design_matches_plain(b, sq, sk, hq, hkv, mask):
    """hd 256's design (64-key dK/dV blocks, two owners of half of hd
    each recomputing S^T and dP^T, the 2-stage walk and its skips; P and
    dS rounded to bf16 before their products) against
    ``flash_attention_bwd_plain`` within the card's 3e-2 of max(1,
    |want|) and 1e-2 of each gradient row's L2 norm; with P and dS in
    fp32 within 1e-4."""
    ins = _bwd_inputs(sq + sk + hq, b, sq, sk, hq, hkv, 256, **mask)
    want = flash_attention_bwd_plain(*[t.float() for t in ins], **mask)
    kw = dict(causal=mask.get("causal", True), window=mask.get("window"),
              q_offset=mask.get("q_offset", 0))

    def rel(got):
        return max(float((g - w).abs().max() / max(1.0, float(w.abs().max())))
                   for g, w in zip(got, want))
    got = k4_bwd_emulate(*ins, **kw)
    assert rel(got) < 3e-2
    assert _row_rel(got, want) < 1e-2
    assert rel(k4_bwd_emulate(*ins, bf16_points=False, **kw)) < 1e-4


@pytest.mark.parametrize("causal", [True, False])
def test_k4_bwd_design_rounds_only_p_and_ds(causal):
    """With P and dS kept in fp32 the backward's tiling, its walks and
    the log2-domain exp give the plain version's fp32 gradients (1e-4 of
    max(1, |want|)); rounding P and dS to bf16 before their products is
    the one deliberate difference, and stays inside 3e-2."""
    ins = _bwd_inputs(7, 1, 200, 200, 4, 2, 64, causal=causal)
    want = flash_attention_bwd_plain(*[t.float() for t in ins],
                                     causal=causal)

    def rel(got):
        return max(float((g - w).abs().max()
                         / max(1.0, float(w.abs().max())))
                   for g, w in zip(got, want))
    assert rel(k4_bwd_emulate(*ins, causal=causal,
                              bf16_points=False)) < 1e-4
    assert 1e-4 < rel(k4_bwd_emulate(*ins, causal=causal)) < 3e-2


# ------------------------------------------------------------------ K3

def _state(qh, k, v, scale):
    """(max, sum, acc) of one part: qh [G, hd], k/v [T, hd]."""
    if k.shape[0] == 0:
        return (torch.full((qh.shape[0],), NEG), torch.zeros(qh.shape[0]),
                torch.zeros_like(qh))
    s = qh @ k.T * scale
    m = s.amax(-1)
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), p @ v


def _merge(states):
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    tot = sum(l * torch.exp(m - mx) for m, l, _ in states)
    acc = sum(a * torch.exp(m - mx)[:, None] for m, _, a in states)
    return mx, tot, acc


def k3_emulate(q, k_pages, v_pages, page_tbl, lens, cs):
    """K3's split and merge: block r of the cluster takes valid pages
    [r * per, (r + 1) * per), per = ceil(n_pages / cs); lane group sb of
    a block takes the chunks of ``K3_TOKENS`` tokens starting at
    t0 + sb * K3_TOKENS, strided by all groups; out-of-pool pages are
    skipped; states merge in the block, then across the cluster."""
    b, hq, hd = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    mp = page_tbl.shape[1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros((b, hq, hd))
    step = K3_LANE_GROUPS * K3_TOKENS
    for bi in range(b):
        n = min(max(int(lens[bi]), 0), mp * page)
        n_pg = -(-n // page)
        per = -(-n_pg // cs)
        for kh in range(hkv):
            qh = q[bi, kh * g:(kh + 1) * g].float()
            blocks = []
            for r in range(cs):
                pg0, pg1 = r * per, min(n_pg, (r + 1) * per)
                t0, t1 = pg0 * page, min(n, pg1 * page)
                parts = []
                for sb in range(K3_LANE_GROUPS):
                    toks = [t for base in range(t0 + sb * K3_TOKENS, t1, step)
                            for t in range(base, min(base + K3_TOKENS, t1))
                            if 0 <= int(page_tbl[bi, t // page]) < n_pool]
                    pg = [int(page_tbl[bi, t // page]) for t in toks]
                    off = [t % page for t in toks]
                    parts.append(_state(qh, k_pages[pg, off, kh].float(),
                                        v_pages[pg, off, kh].float(), scale))
                blocks.append(_merge(parts))
            _, tot, acc = _merge(blocks)
            out[bi, kh * g:(kh + 1) * g] = acc / tot.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _k3_inputs(seed, b, hq, hkv, hd, page, mp, pool, tails):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, hd)).astype(np.float32)
    kp = rng.normal(size=(pool, page, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(pool, page, hkv, hd)).astype(np.float32)
    lens = rng.integers(1, mp * page + 1, b).astype(np.int32)
    lens[0], lens[1] = 0, mp * page             # idle slot, full window
    tbl = rng.permutation(pool)[:b * mp].reshape(b, mp).astype(np.int32)
    if tails:                                   # -1 past the valid pages
        for i, n in enumerate(lens):
            tbl[i, -(-int(n) // page):] = -1
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("hq,hkv,hd,page,mp", [(8, 2, 64, 8, 8),
                                               (4, 4, 128, 16, 5)])
def test_k3_design_matches_reference(cs, hq, hkv, hd, page, mp):
    ins = _k3_inputs(cs, 5, hq, hkv, hd, page, mp, 48, tails=True)
    want = np.asarray(jax_decode_paged(*[jnp.asarray(a) for a in ins],
                                       backend="ref"))
    got = k3_emulate(*[torch.from_numpy(a) for a in ins], cs).numpy()
    live = ins[4] > 0
    assert np.abs(got[live] - want[live]).max() < 2e-5
    assert not got[~live].any()                 # lens == 0 -> zeros


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_k3_design_matches_pallas_interpret(cs):
    ins = _k3_inputs(10 + cs, 3, 8, 2, 64, 8, 6, 24, tails=False)
    want = np.asarray(jax_decode_paged(*[jnp.asarray(a) for a in ins],
                                       backend="pallas", interpret=True))
    got = k3_emulate(*[torch.from_numpy(a) for a in ins], cs).numpy()
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("max_pages,cs", [(0, 1), (1, 1), (2, 2), (3, 2),
                                          (16, 2), (32, 2), (64, 2),
                                          (1024, 2), (65536, 2)])
def test_k3_cluster_size_follows_the_window(max_pages, cs):
    """Two blocks per (sequence, kv head), one where the window has a
    single page: the serve's 16-page windows take 2."""
    assert cluster_size(max_pages) == cs


# ------------------------------------------------------------------ K5

def tf32_rna(x):
    """fp32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits to the
    magnitude's bit pattern, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def k5_emulate(cb, cs, win, terms=3):
    """K5's arithmetic on cb [B, Q, Q], cs [B, Q, H], win [B, Q, H, P]:
    keys in steps of 8, in order; the step's scores S = cb * exp2((cs[q]
    - cs[k]) * log2 e), selected to 0 above the diagonal; with
    ``terms=3`` small.big, big.small and big.big added in that order to
    an fp32 sum, with ``terms=1`` big.big alone (one TF32 product).  The
    kernel skips the steps past a warp's last row; here they add exact
    zeros."""
    b, q, h, p = win.shape
    cbf, csf = cb.float(), cs.float().permute(0, 2, 1)      # [B, H, Q]
    wf = win.float().permute(0, 2, 1, 3)                     # [B, H, Q, P]
    rows = torch.arange(q)[:, None]
    acc = torch.zeros((b, h, q, p))
    for k0 in range(0, q, 8):
        keys = torch.arange(k0, min(k0 + 8, q))
        dec = torch.exp2((csf[:, :, :, None] - csf[:, :, None, keys])
                         * math.log2(math.e))
        dec = torch.where(keys[None, :] <= rows, dec, 0.0)  # select first
        s = cbf[:, None, :, keys] * dec                      # [B, H, Q, 8]
        wk = wf[:, :, keys]                                  # [B, H, 8, P]
        a_big, a_small = tf32_split(s)
        b_big, b_small = tf32_split(wk)
        if terms == 3:
            acc = acc + a_small @ b_big
            acc = acc + a_big @ b_small
        acc = acc + a_big @ b_big
    return acc.permute(0, 2, 1, 3).to(win.dtype)


def test_tf32_rna_rounds_half_away_from_zero():
    ulp = 2.0 ** -10                       # TF32's step in [1, 2)
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2
                      - 2.0 ** -23, 1.0 + 1.5 * ulp, 3.0])
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0])
    assert torch.equal(tf32_rna(x), want)
    big, small = tf32_split(torch.tensor([math.pi]))
    assert abs(float(big + small) - math.pi) < 2.0 ** -20


@pytest.mark.parametrize("b,q,h,p", [(2, 32, 4, 16), (1, 64, 8, 64)])
def test_k5_design_matches_pallas(b, q, h, p):
    """``tests/test_kernels.py``'s fp32 cases and inputs."""
    rng = np.random.default_rng(4)
    cb = rng.normal(size=(b, q, q)).astype(np.float32) * 0.3
    cs = (-np.abs(rng.normal(size=(b, q, h))).cumsum(axis=1)
          * 0.1).astype(np.float32)
    win = rng.normal(size=(b, q, h, p)).astype(np.float32)
    want = np.asarray(jax_intra_chunk(jnp.asarray(cb), jnp.asarray(cs),
                                      jnp.asarray(win), backend="pallas",
                                      interpret=True))
    got = k5_emulate(*[torch.from_numpy(a) for a in (cb, cs, win)]).numpy()
    assert np.abs(got - want).max() < 2e-4


def test_k5_design_matches_plain_with_a_steep_cumsum():
    """``chip_smoke.check_ssd``'s inputs (a cumsum steep enough that exp
    overflows above the diagonal) at 2 chunks of Q 256, 4 heads, P 64.
    3xTF32 agrees with the function evaluated in float64 within 1e-5 of
    the scale, and with ``ssd_intra_plain`` within the kernel's 2e-4 of
    the scale; one TF32 product misses 2e-4.  (``ssd_intra_plain`` is
    itself an fp32 einsum whose error against float64 varies from run to
    run on the CPU, up to a few 1e-5 of the scale, so the tight bound is
    held against float64.)"""
    rng = np.random.default_rng(5)
    b, q, h, p = 2, 256, 4, 64
    cb = torch.from_numpy(rng.normal(size=(b, q, q)).astype(np.float32))
    cs = torch.from_numpy((-np.abs(rng.normal(size=(b, q, h)))
                           .cumsum(axis=1)).astype(np.float32))
    win = torch.from_numpy(rng.normal(size=(b, q, h, p)).astype(np.float32))
    seg = cs.double()[:, :, None, :] - cs.double()[:, None, :, :]
    causal = torch.ones((q, q), dtype=torch.bool).tril()[None, :, :, None]
    exact = torch.einsum("bqk,bqkh,bkhp->bqhp", cb.double(),
                         torch.where(causal, torch.exp(seg), 0.0),
                         win.double())
    scale = max(1.0, exact.abs().max().item())
    got = k5_emulate(cb, cs, win)
    assert torch.isfinite(got).all()
    assert (got.double() - exact).abs().max().item() < 1e-5 * scale
    want = ssd_intra_plain(cb, cs, win)
    assert (got - want).abs().max().item() < 2e-4 * scale
    one = k5_emulate(cb, cs, win, terms=1)
    assert (one.double() - exact).abs().max().item() > 2e-4 * scale


# ------------------------------------------------------- K5's backward

K5B_KEYS = 64             # keys of a block (16 a warp)
K5B_ROWS = 64             # query rows of a step
K5B_HEADS = 8             # heads of a block's group


def mma3(a, b, terms=3):
    """a @ b as the kernel's tensor cores add it for one 8-deep k-step:
    small.big, big.small, then big.big (``terms=1``: big.big alone)."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    if terms == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def k5_bwd_emulate(cb, cs, win, dy, y, terms=3):
    """``csrc/ssd_intra_bwd.cu``'s arithmetic, in fp32: per chunk, a
    block of 64 keys and 8 heads walks its heads in order and, for each,
    the query rows at or below its keys in steps of 64, each step's rows
    in two halves of 32 (the block's two halves of 4 warps).  A half
    takes G^T = Win dY^T in 8-deep k-steps over P and dWin += (CB o L)^T
    dY in 8-row k-steps, both in 3xTF32 (``mma3``), with L selected to 0
    above the diagonal before its exp; it adds L o G^T into the block's
    dCB strip (so a strip sums its heads in head order) and (CB o L o
    G)^T's row sums into each key's column sum of dS.  At a head's end
    the second half's dWin and column sums come first, the first half's
    are added to them; dcs = sum_p dY Y - the column sum.  A key tile's
    strips are summed in group order.  Returns (dcb, dcs, dwin)."""
    bc, q, h, p = win.shape
    cbf, csf = cb.float(), cs.float()
    w = win.float().permute(0, 2, 1, 3)                  # [B, H, Q, P]
    d = dy.float().permute(0, 2, 1, 3)
    dwin = torch.zeros(bc, h, q, p)
    col = torch.zeros(bc, h, q)
    groups = -(-h // K5B_HEADS)
    dcb = torch.zeros(bc, q, q)
    for k0 in range(0, q, K5B_KEYS):
        keys = torch.arange(k0, min(k0 + K5B_KEYS, q))
        strips = []
        for gi in range(groups):
            strip = torch.zeros(bc, q, len(keys))
            for hh in range(gi * K5B_HEADS, min(h, (gi + 1) * K5B_HEADS)):
                dw = [torch.zeros(bc, len(keys), p) for _ in range(2)]
                cl = [torch.zeros(bc, len(keys)) for _ in range(2)]
                for r0 in range(k0, q, K5B_ROWS):
                    for half in range(2):
                        lo = r0 + 32 * half
                        if lo >= q:
                            continue
                        rows = torch.arange(lo, min(lo + 32, q))
                        gt = torch.zeros(bc, len(keys), len(rows))
                        for p0 in range(0, p, 8):
                            gt = gt + mma3(w[:, hh, keys, p0:p0 + 8],
                                           d[:, hh, rows, p0:p0 + 8]
                                           .transpose(-1, -2), terms)
                        ok = keys[:, None] <= rows[None, :]   # select first
                        seg = torch.where(ok, csf[:, rows, hh][:, None, :]
                                          - csf[:, keys, hh][:, :, None], 0.0)
                        lt = torch.where(
                            ok, torch.exp2(seg * math.log2(math.e)), 0.0)
                        clt = cbf[:, rows][:, :, keys].transpose(-1, -2) * lt
                        strip[:, rows] += (lt * gt).transpose(-1, -2)
                        cl[half] += (clt * gt).sum(-1)
                        for j0 in range(0, len(rows), 8):
                            dw[half] += mma3(clt[:, :, j0:j0 + 8],
                                             d[:, hh, rows[j0:j0 + 8]], terms)
                dwin[:, hh, keys] = dw[1] + dw[0]
                col[:, hh, keys] = cl[1] + cl[0]
            strips.append(strip)
        total = torch.zeros_like(strips[0])
        for s in strips:                                        # group order
            total = total + s
        dcb[:, :, keys] = total
    rowsum = (dy.float() * y.float()).sum(-1)                  # [B, Q, H]
    dcs = rowsum - col.permute(0, 2, 1)
    return dcb, dcs, dwin.permute(0, 2, 1, 3)


def _k5_bwd_inputs(seed, bc, q, h, p):
    rng = np.random.default_rng(seed)
    cb, cs, win, dy = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(bc, q, q)),
        -np.abs(rng.normal(size=(bc, q, h))).cumsum(axis=1),
        rng.normal(size=(bc, q, h, p)), rng.normal(size=(bc, q, h, p)))]
    return cb, cs, win, dy, ssd_intra_plain(cb, cs, win)


def _rel(got, want):
    return max(float((g.double() - w.double()).abs().max()
                     / max(1.0, float(w.abs().max())))
               for g, w in zip(got, want))


@pytest.mark.parametrize("bc,q,h,p", [(1, 256, 9, 64), (2, 100, 3, 16),
                                      (1, 200, 10, 32), (1, 130, 2, 128)])
def test_k5_bwd_design_matches_plain_with_a_steep_cumsum(bc, q, h, p):
    """The design against ``ssd_intra_bwd_plain`` on
    ``chip_smoke.check_ssd_bwd``'s inputs (a cumsum steep enough that exp
    overflows above the diagonal), at Q not a multiple of 64 and head
    counts that 8 does not divide: finite, and within the card's 1e-4 of
    max(1, |want|) for each gradient."""
    cb, cs, win, dy, y = _k5_bwd_inputs(q + h + p, bc, q, h, p)
    assert torch.isinf(torch.exp(cs[:, None, :, :] - cs[:, :, None, :])).any()
    got = k5_bwd_emulate(cb, cs, win, dy, y)
    assert all(torch.isfinite(g).all() for g in got)
    assert _rel(got, ssd_intra_bwd_plain(cb, cs, win, dy)) < 1e-4


def test_k5_bwd_design_needs_three_tf32_terms():
    """Against the function in float64 (select before exp), 3xTF32 errs
    by under 1e-5 of max(1, |want|); one TF32 product of each pair errs
    by more than the card's 1e-4."""
    bc, q, h, p = 1, 256, 4, 64
    cb, cs, win, dy, y = _k5_bwd_inputs(3, bc, q, h, p)
    l_mat = torch.where(torch.ones(q, q, dtype=torch.bool).tril()[None, :, :,
                                                                  None],
                        torch.exp(torch.where(
                            torch.ones(q, q, dtype=torch.bool)
                            .tril()[None, :, :, None],
                            cs.double()[:, :, None] - cs.double()[:, None],
                            0.0)), 0.0)
    g = torch.einsum("bqhp,bkhp->bqkh", dy.double(), win.double())
    cbl = cb.double()[..., None] * l_mat
    ds = cbl * g
    exact = ((l_mat * g).sum(-1), ds.sum(2) - ds.sum(1),
             torch.einsum("bqkh,bqhp->bkhp", cbl, dy.double()))
    # the emulation takes sum_p dY Y from Y in float64 too, as the kernel
    # reads the forward's own Y (a bound on K5's error is not this test's)
    y64 = torch.einsum("bqkh,bkhp->bqhp", cbl, win.double())
    assert _rel(k5_bwd_emulate(cb, cs, win, dy, y64), exact) < 1e-5
    assert _rel(k5_bwd_emulate(cb, cs, win, dy, y64, terms=1), exact) > 1e-4


def test_k5_bwd_design_sums_heads_then_groups_in_order():
    """dCB of a key tile is each group's strip summed over its heads in
    head order, then the groups in group order: the design's dcb equals
    that sum taken explicitly from per-head terms, bit for bit, and two
    runs give the same bits."""
    bc, q, h, p = 1, 128, 20, 16
    cb, cs, win, dy, y = _k5_bwd_inputs(9, bc, q, h, p)
    got = k5_bwd_emulate(cb, cs, win, dy, y)[0]
    assert torch.equal(got, k5_bwd_emulate(cb, cs, win, dy, y)[0])
    per_head = [k5_bwd_emulate(cb, cs[:, :, [j]], win[:, :, [j]],
                               dy[:, :, [j]], y[:, :, [j]])[0]
                for j in range(h)]
    want = torch.zeros_like(got)
    for gi in range(0, h, K5B_HEADS):
        strip = torch.zeros_like(got)
        for j in range(gi, min(h, gi + K5B_HEADS)):
            strip = strip + per_head[j]
        want = want + strip
    assert torch.equal(got, want)


# ------------------------------------------------------------------ K1

_U64 = (1 << 64) - 1


def _word(hi, lo):
    return ((int(hi) & 0xFFFFFFFF) << 32) | (int(lo) & 0xFFFFFFFF)


def _lanes(w):
    return (np.int32(np.uint32(w >> 32)), np.int32(np.uint32(w & 0xFFFFFFFF)))


def k1_emulate(words, req, lines_per_block):
    """K1's partition: block b owns lines [b * L, (b + 1) * L); it finds
    each line's first request (the least index, the kernel's atomicMin
    table) and walks the line's chain from it in request order, the word
    held as one 64-bit value.  Empty slots and lines past N reply zeros,
    not ok (block 0 writes them)."""
    n, r = words.shape[0], req["line"].shape[0]
    line = req["line"]
    new = words.copy()
    old_hi = np.zeros(r, np.int32)
    old_lo = np.zeros(r, np.int32)
    ok = np.zeros(r, np.int32)
    for l0 in range(0, max(n, 1), lines_per_block):
        in_slice = (line >= l0) & (line < min(n, l0 + lines_per_block))
        first = {}
        for i in np.nonzero(in_slice)[0]:
            first[int(line[i])] = min(first.get(int(line[i]), r), int(i))
        for ln, f in first.items():
            w = _word(*words[ln])
            for j in f + np.nonzero(line[f:] == ln)[0]:
                old_hi[j], old_lo[j] = _lanes(w)
                arg = _word(req["arg_hi"][j], req["arg_lo"][j])
                if req["op"][j] == 0:
                    hit = w == _word(req["cmp_hi"][j], req["cmp_lo"][j])
                    w = arg if hit else w
                    ok[j] = int(hit)
                else:
                    w = (w + arg) & _U64
                    ok[j] = 1
            new[ln] = _lanes(w)
    return new, old_hi, old_lo, ok


@pytest.mark.parametrize("n,n_lines,same_line", [
    (200, 200, False),           # 4 slices of 64, the last one ragged
    (192, 12, False),            # long chains on a few lines
    (200, 1, True),              # one line named by every request
])
def test_k1_design_matches_pallas(n, n_lines, same_line):
    rng = np.random.default_rng(n + n_lines)
    r = 1500
    words = rng.integers(-2**31, 2**31, (n, 2)).astype(np.int32)
    words[:4, 1] = -1                          # lo = 0xFFFFFFFF: carries
    words[0, 0] = -1                           # whole word 2**64 - 1
    if same_line:
        line = np.full(r, 137, np.int32)
    else:
        line = rng.choice(rng.permutation(n)[:n_lines], r).astype(np.int32)
        line[rng.random(r) < 0.1] = -1
    cmp = words[np.maximum(line, 0)].copy()
    miss = rng.random(r) < 0.5
    cmp[miss] = rng.integers(-2**31, 2**31, (miss.sum(), 2))
    req = {"line": line, "op": rng.integers(0, 2, r).astype(np.int32),
           "arg_hi": rng.integers(-4, 4, r).astype(np.int32),
           "arg_lo": rng.integers(-2**31, 2**31, r).astype(np.int32),
           "cmp_hi": cmp[:, 0].astype(np.int32),
           "cmp_lo": cmp[:, 1].astype(np.int32)}
    want = jax_apply_batch(jnp.asarray(words),
                           {k: jnp.asarray(v) for k, v in req.items()},
                           backend="pallas", interpret=True)
    got = k1_emulate(words, req, lines_per_block=64)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------------------ K2

def k2_emulate(pages, words, req_page, bit_hi, bit_lo, *, slice_pages,
               threads, vecs):
    """K2's partition, in numpy: merge blocks over slices of
    ``slice_pages`` pages whose OR tables take ``threads`` requests a
    pass, then (request, chunk of ``threads * vecs`` 16-byte vectors)
    copy tiles over each row's bytes.  Counts the writes to every
    output element and asserts each was written once."""
    p, r = pages.shape[0], req_page.shape[0]
    src = pages.reshape(p, -1).view(np.uint8)
    row_bytes = src.shape[1]
    payload = np.zeros((r, row_bytes), np.uint8)
    new_words = np.zeros_like(words)
    reply = np.zeros((3, r), np.int32)
    wrote = {"payload": np.zeros((r, row_bytes), int),
             "new_words": np.zeros(p, int), "reply": np.zeros(r, int)}
    for p0 in range(0, p, slice_pages):                 # merge blocks
        n = min(slice_pages, p - p0)
        table = np.zeros((n, 2), np.int32)
        for t0 in range(0, r, threads):                 # one pass
            for i in range(t0, min(r, t0 + threads)):
                q = int(req_page[i]) - p0
                if 0 <= q < n:
                    table[q] |= (bit_hi[i], bit_lo[i])
        new_words[p0:p0 + n] = words[p0:p0 + n] | table
        wrote["new_words"][p0:p0 + n] += 1
    chunk = threads * vecs * 16
    for i in range(r):                                  # copy tiles
        page = int(req_page[i])
        valid = 0 <= page < p
        for c in range(max(1, -(-row_bytes // chunk))):
            cut = slice(c * chunk, min(row_bytes, (c + 1) * chunk))
            payload[i, cut] = src[page, cut] if valid else 0
            wrote["payload"][i, cut] += 1
            if c == 0:
                hi, lo = words[page] if valid else (0, 0)
                reply[:, i] = (hi, lo, int(valid and (hi & WRITER_MASK_HI)
                                           == 0))
                wrote["reply"][i] += 1
    for name, count in wrote.items():
        assert (count == 1).all(), f"{name}: an element not written once"
    return (payload.view(pages.dtype).reshape(r, *pages.shape[1:]),
            reply[0], reply[1], reply[2], new_words)


def _k2_inputs(seed, p, e, r, dtype, bits):
    """Requests name pages 1.. (JAX's ``.at[].set`` sends an empty slot
    to page 0, where it would race a real request) or -1.  ``bits``:
    "distinct" pages with random bits; "equal" duplicates with equal
    bits; "unequal" duplicates with random bits."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        pages = rng.integers(-2**31, 2**31, (p, e)).astype(np.int32)
    else:
        pages = rng.normal(size=(p, e)).astype(dtype)
    words = rng.integers(0, 2**20, (p, 2)).astype(np.int32)
    words[::3, 0] |= 5 << 24                   # some exclusive holders
    if bits == "distinct":
        req = 1 + rng.permutation(p - 1)[:r].astype(np.int32)
    else:
        req = rng.integers(1, p // 4, r).astype(np.int32)
    if bits == "equal":
        bh, bl = np.full(r, 1 << 3, np.int32), np.full(r, 1 << 9, np.int32)
    else:
        bh, bl = rng.integers(0, 2**30, (2, r)).astype(np.int32)
    req[rng.random(r) < 0.2] = -1
    return pages, words, req, bh, bl


@pytest.mark.parametrize("dtype,bits", [(np.int32, "distinct"),
                                        (np.float32, "distinct"),
                                        (np.int32, "equal")])
def test_k2_design_matches_pallas(dtype, bits):
    """P 70 in slices of 16, R 40 in passes of 16, rows of 400 bytes in
    chunks of 256."""
    args = _k2_inputs(7, 70, 100, 40, dtype, bits)
    want = jax_fetch(*[jnp.asarray(a) for a in args], backend="pallas",
                     interpret=True)
    got = k2_emulate(*args, slice_pages=16, threads=16, vecs=1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("p,e,r", [(70, 100, 40), (33, 7, 90)])
def test_k2_design_matches_plain_with_unequal_duplicates(p, e, r):
    """Duplicate requests OR their bits (the port's semantics); 28-byte
    rows, as the byte path takes them, fit one chunk."""
    args = _k2_inputs(p + r, p, e, r, np.int32, "unequal")
    want = gcl_fetch_plain(*[torch.from_numpy(a) for a in args])
    got = k2_emulate(*args, slice_pages=16, threads=16, vecs=1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w.numpy())



@pytest.mark.parametrize("p,e,r", [
    (70, 100, 40), (33, 7, 90), (17, 1030, 5), (40, 64, 1), (16, 100, 0),
    (9, 100, 40), (200, 3, 64), (64, 512, 33)])
def test_k2_design_at_two_vectors_a_thread_with_far_pages(p, e, r):
    """The kernel's own chunk of 2 vectors a thread (here 16 threads, so
    512-byte chunks), with two empty slots naming pages far past P
    (2^30 and 2^31 - 1) instead of -1: they stay empty slots, and no
    merge slice takes their bits."""
    args = _k2_inputs(p * r + e, p, e, r, np.int32, "unequal")
    want = gcl_fetch_plain(*[torch.from_numpy(a) for a in args])
    far = args[2].copy()
    empty = np.flatnonzero(far < 0)[:2]
    far[empty] = np.array([2**30, 2**31 - 1], np.int32)[:len(empty)]
    got = k2_emulate(args[0], args[1], far, *args[3:], slice_pages=16,
                     threads=16, vecs=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w.numpy())
