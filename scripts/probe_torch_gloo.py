"""What one collective costs between gloo ranks that share a card.

    python3 scripts/probe_torch_gloo.py [--ranks 4]

Spawns ``--ranks`` ranks on the one CUDA device (``parallel.dist.spawn``;
gloo, since NCCL refuses two ranks on one GPU) on a ``Mesh`` whose data
axis they split, and times on each (host clock around synchronised
calls, the mean of 5 calls after a warm-up, ms) what phase 7e's
FSDP step issues: the all-gather of one 25 MB bf16 block, of one 1.8 MB
block and of seven 1.8 MB blocks one call each, the fp32 reduce-scatter
of a 100 MB bf16 leaf, an ``all_to_all`` of 100 MB from CUDA and from
host tensors, gloo's own ``all_gather_into_tensor`` of the 25 MB block
and a plain 100 MB device-to-host copy.  Rank 0 prints them with the
card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank, world, tmp):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.core.rounds import Mesh
    from repro_torch.parallel import dist as pd
    group, dev = pd.init(init_method="file://" + os.path.join(tmp, "rv"),
                         device="cuda")
    mesh = Mesh({"data": 16, "model": 16}, dev, group=group,
                ranks={"data": world})
    gen = torch.Generator(device=dev).manual_seed(rank)
    blk = torch.randn(512, 12288, generator=gen, device=dev).bfloat16()
    small = [torch.randn(512, 1792, generator=gen, device=dev).bfloat16()
             for _ in range(7)]
    whole = torch.randn(2048, 12288, generator=gen, device=dev).bfloat16()
    host = whole.cpu()

    def ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    out = torch.empty((world * blk.shape[0], blk.shape[1]), dtype=blk.dtype,
                      device=dev)
    res = {
        "all_gather_25MB": ms(lambda: mesh.all_gather(blk, 0, "data")),
        "all_gather_1.8MB": ms(lambda: mesh.all_gather(small[0], 0,
                                                       "data")),
        "all_gather_7x1.8MB": ms(lambda: [mesh.all_gather(x, 0, "data")
                                          for x in small]),
        "reduce_scatter_100MB_bf16_in_fp32": ms(
            lambda: mesh.reduce_scatter(whole, 0, "data")),
        "all_to_all_100MB_cuda": ms(lambda: mesh.all_to_all(whole,
                                                            axis="data")),
        "all_to_all_100MB_host": ms(lambda: dist.all_to_all_single(
            torch.empty_like(host), host, group=group)),
        "gloo_all_gather_into_tensor_25MB": ms(
            lambda: dist.all_gather_into_tensor(out, blk, group=group)),
        "device_to_host_100MB": ms(lambda: whole.cpu()),
    }
    if rank == 0:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(card, flush=True)
        print({k: round(v, 3) for k, v in res.items()}, flush=True)
    pd.finish()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_gloo: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.parallel.dist import spawn
    with tempfile.TemporaryDirectory() as tmp:
        spawn(rank_main, args.ranks, args=(tmp,), timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
