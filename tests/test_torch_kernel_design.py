"""The arithmetic of the Hopper designs of K4 and K3, emulated on the CPU.

The CUDA kernels run only on the card; what their designs change in
the numbers is pinned down here, against the JAX package's kernels:

* K4 (``csrc/flash_attention.cu``, bf16 inputs): tiles of 64 keys, an
  online softmax in fp32 in the log2 domain, and the probabilities
  rounded to bf16 before the P.V product (the Pallas kernel keeps P in
  fp32).  Held against the Pallas kernel in interpret mode at
  ``tests/test_kernels.py``'s bf16 shapes and at ragged S, within that
  file's bf16 tolerance of 2e-2.
* K3 (``csrc/paged_attention.cu``): the window's valid pages split into
  per-block slices of a cluster of 1/2/4/8 blocks, each slice split
  again over the block's lane groups (chunks of 4 tokens); every part
  keeps a (max, sum, acc) state, and the states merge by rescaling to
  the largest max.  Held against ``decode_paged`` (the JAX reference
  and the Pallas kernel in interpret mode) within 2e-5 in fp32.

Neither emulation is on any path of the port: they are the kernels'
algorithms written out in PyTorch, for this file alone.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.ops import \
    attention as jax_flash  # noqa: E402
from repro.kernels.paged_attention.ops import \
    decode_paged as jax_decode_paged  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402
from repro_torch.kernels.paged_attention import \
    cluster_size  # noqa: E402

K4_TILE = 64              # keys per tile of the bf16 kernel
K3_LANE_GROUPS = 16       # lane groups of a block (bf16 rows at hd 128)
K3_TOKENS = 4             # tokens a lane group has in flight
NEG = -1e30


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------------ K4

def k4_emulate(q, k, v, *, causal, p_bf16=True):
    """The bf16 K4's arithmetic on [B, H, S, hd] tensors: fp32 scores of
    the inputs, scaled into the log2 domain, an online softmax over
    64-key tiles (a masked probability selected to 0), P rounded to
    bf16 when ``p_bf16``, fp32 sums.  Returns the fp32 output before
    the kernel's final cast.  The kernel skips tiles above the causal
    diagonal; here they are visited fully masked, which changes
    nothing (max unchanged, probabilities 0)."""
    b, hq, s, hd = q.shape
    g = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hq, s, 1), NEG)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, hd))
    for k0 in range(0, s, K4_TILE):
        keys = torch.arange(k0, min(k0 + K4_TILE, s))[None, :]
        x = qf @ kf[:, :, k0:k0 + K4_TILE].transpose(-1, -2) * scale_log2
        ok = keys <= rows if causal else torch.ones_like(keys, dtype=bool)
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
