"""K3 and K4 beside SDPA, K2 beside ``index_select``, K1 and K5, and the
backward kernels of K4 and K5, on one NVIDIA GPU at the main path's
shapes.

    python3 scripts/bench_attention_kernels.py [--src DIR] [--label NAME]
        [--out-dir build/bench] [--phases] [--only k4 k4bwd ...]

Builds the CUDA kernels of the ``repro_torch`` package under ``--src``
(default: this checkout's ``src``; point it at an unpacked older commit
to compare two versions on one card, in turns: parent, change, change,
parent) and runs ``chip_smoke.py``'s own checks of K3, K4, K2, K1 and K5
on them (``check_attention``, ``check_flash``, ``check_fetch``,
``check_latch``, ``check_ssd``: each kernel at the main path's shape
against its plain version, timed on one call a CUDA graph and on 20, K3
and K4 beside SDPA, K2 also at the serve's mix of granted and empty
rows and with rotating rows), after the launch floor of both timers
(``launch_floor``).

Also torch's own zero fill and row copy of the 32 rows of 64 KiB that
K2 writes at the serve's mix, on 20 calls a graph (``fetch_floor``).

Where the package splits K3's window across a thread-block cluster
(``paged_attention.cluster_size``), also K3 at windows of 256 (the
serve's), 512 and 1024 tokens with clusters of 1, 2, 4 and 8 blocks,
through its C entry point, beside SDPA at each window.

With ``--phases``, also where a key tile's time goes in bf16 K4 at the
Qwen3-1.7B prefill shape: a copy of ``csrc/flash_attention.cu`` that
reads ``clock64`` at each ``// PHASE <name>`` line of its loop (summed
over warp 0 of every block) is built beside the package's libraries
and run once.

``--only`` runs just the named kernels' checks (k1-k5, and k4bwd and
k5bwd for the backward kernels of the training path:
``check_flash_bwd`` at ``FLASH_BWD_CASES`` beside autograd of SDPA, and
``check_ssd_bwd`` at the Mamba2-2.7B training shape; the launch floor
always runs; ``--bwd-cases`` names the ``FLASH_BWD_CASES`` tags to run,
'' for the Qwen3 case, so that an older commit's kernel runs only the
cases it takes; each case prints a ``digest`` of its gradients' bits).  To compare the backward kernels with an older commit's,
unpack it (``git archive <commit> | tar -x -C build/parent``) and run,
in one chip call, in turns (parent, change, change, parent):

    B="python3 scripts/bench_attention_kernels.py --only k4bwd k5bwd"
    $B --src build/parent/src --label parent1; $B --label change1
    $B --label change2; $B --src build/parent/src --label parent2

Prints the card's name and power limit, then one JSON line, also
written to ``<out-dir>/bench_attention_<label>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def cluster_sweep(dev):
    """K3 at windows of 16, 32 and 64 pages of 16 tokens with each
    cluster size, beside the size ``cluster_size`` picks and SDPA."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as PA
    lib = _build.load("paged_attention", PA._SIGNATURES)
    out = {}
    for mp in (16, 32, 64):
        q, kp, vp, tbl, lens = chip_smoke.attention_inputs(dev, mp)
        want = PA.paged_attention_plain(q, kp, vp, tbl, lens)
        b, hq, hd = q.shape
        n_pool, page, hkv, _ = kp.shape

        def call(c):
            o = torch.empty_like(q)
            _build.check(lib.paged_attention_launch(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kp.stride(0),
                tbl.data_ptr(), lens.data_ptr(), o.data_ptr(), b, hq, hkv,
                hd, page, mp, n_pool, 1.0 / math.sqrt(hd), 0, 1, c,
                _build.stream_of(q)), "paged_attention")
            return o

        row = {"rule": PA.cluster_size(mp),
               "sdpa_ms": chip_smoke.graph_ms(
                   chip_smoke.paged_sdpa(q, kp, vp, tbl, lens))}
        for c in (1, 2, 4, 8):
            e = float((call(c) - want).abs().max())
            assert e < 1e-4, f"K3 off by {e} with a cluster of {c}"
            row[f"cluster{c}_ms"] = chip_smoke.graph_ms(lambda: call(c))
        out[f"window{mp * page}"] = row
    return out


def fetch_floor(dev):
    """Two torch kernels that write what K2 writes at the serve's mix,
    32 rows of 64 KiB, on 20 calls a graph: a zero fill, and a copy of
    32 contiguous rows of a 1024-page image."""
    pages = torch.ones((1024, 16384), dtype=torch.int32, device=dev)
    out = torch.empty((32, 16384), dtype=torch.int32, device=dev)
    return {"zero_fill_32_rows_ms_graph20": chip_smoke.graph20_ms(out.zero_),
            "copy_32_rows_ms_graph20": chip_smoke.graph20_ms(
                lambda: out.copy_(pages[:32]))}


def k4_phases(dev, src_dir):
    """Mean cycles per key tile of each phase of the bf16 K4 loop (warp
    0 of each block) at the Qwen3-1.7B prefill shape, S 512, causal."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _SIGNATURES
    src = os.path.join(src_dir, "repro_torch", "csrc", "flash_attention.cu")
    names, text = [], "__device__ unsigned long long phase_cycles[8];\n"
    for line in open(src).read().splitlines(keepends=True):
        mark = re.fullmatch(r"(\s*)// PHASE (\w+)\s*", line)
        if mark:
            pad, name = mark.groups()
            text += f"{pad}const long long ph{len(names)}_ = clock64();\n"
            if name == "end":
                adds = "".join(f"atomicAdd(&phase_cycles[{i}], (unsigned "
                               f"long long)(ph{i + 1}_ - ph{i}_)); "
                               for i in range(len(names)))
                text += (f"{pad}if (tid == 0) {{ {adds}atomicAdd(&phase_"
                         f"cycles[{len(names)}], 1ull); }}\n")
            names.append(name)
        text += line
    assert names and names[-1] == "end" and len(names) <= 8, names
    n = len(names) - 1
    text += ('extern "C" int read_phases(unsigned long long* h) { return '
             '(int)cudaMemcpyFromSymbol(h, phase_cycles, 64); }\n'
             'extern "C" int zero_phases() { unsigned long long z[8] = {0};'
             ' return (int)cudaMemcpyToSymbol(phase_cycles, z, 64); }\n')
    out = _build.BUILD_ROOT / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention_phases.cu").write_text(text)
    lib_path = out / "libflash_attention_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    os.path.dirname(src), "-o", str(lib_path),
                    str(out / "flash_attention_phases.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    rng = np.random.default_rng(4)
    b, hq, hkv, hd, s = 4, 16, 8, 128, 512
    q, k, v = [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                                .astype(np.float32))
               .to(dev, torch.bfloat16).transpose(1, 2)
               for h in (hq, hkv, hkv)]
    o = torch.empty((b, s, hq, hd), dtype=q.dtype, device=dev) \
        .transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[x for t in (q, k, v, o)
                                          for x in t.stride()[:3]])
    assert lib.zero_phases() == 0
    # the C entry point's arguments as the source under test takes them:
    # (Sq, Sk, q_offset) or one S; causal, then window 0 where it has a
    # window argument, then bf16
    n_args = len(_SIGNATURES["flash_attention_launch"])
    lens = [s, s, 0] if n_args == 17 else [s]
    flags = [1, 1] if n_args == 14 else [1, 0, 1]
    _build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        ctypes.addressof(strides), b, hq, hkv, *lens, hd,
        1.0 / math.sqrt(hd), *flags, _build.stream_of(q)),
        "flash_attention (phases)")
    torch.cuda.synchronize()
    h = (ctypes.c_ulonglong * 8)()
    assert lib.read_phases(h) == 0
    tiles = max(1, h[n])
    return {"tiles": h[n], **{names[i]: h[i] / tiles for i in range(n)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build", "bench"))
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--only", nargs="+",
                    choices=("k1", "k2", "k3", "k4", "k5", "k4bwd",
                             "k5bwd"),
                    default=("k1", "k2", "k3", "k4", "k5"))
    ap.add_argument("--bwd-cases", nargs="+", default=None,
                    help="k4bwd's FLASH_BWD_CASES tags (default: all; "
                    "'' is the Qwen3 case)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_attention_kernels: needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as PA
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all()
    res = {"label": args.label, "src": os.path.abspath(args.src),
           "card": card, "launch_floor": chip_smoke.launch_floor()}
    if "k3" in args.only:
        res["k3"] = chip_smoke.check_attention(dev, K)
    if "k4" in args.only:
        res["k4"] = chip_smoke.check_flash(dev, K)
    if "k2" in args.only:
        res["k2"] = chip_smoke.check_fetch(dev, K)
        res["k2_floor"] = fetch_floor(dev)
    if "k1" in args.only:
        res["k1"] = chip_smoke.check_latch(dev, K)
    if "k5" in args.only:
        res["k5"] = chip_smoke.check_ssd(dev, K)
    if "k4bwd" in args.only:
        res["k4bwd"] = chip_smoke.check_flash_bwd(dev, K, args.bwd_cases)
    if "k5bwd" in args.only:
        res["k5bwd"] = chip_smoke.check_ssd_bwd(dev, K)
    if "k3" in args.only and hasattr(PA, "cluster_size"):
        res["k3_clusters"] = cluster_sweep(dev)
    if args.phases:
        res["k4_phase_cycles_per_tile"] = k4_phases(dev, args.src)
    line = json.dumps(res)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir,
                           f"bench_attention_{args.label}.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
