"""The LM stack's meshes; port of ``repro.launch.mesh``.

Each is a :class:`repro_torch.core.rounds.Mesh` with the reference's
named axes on one device (``cuda`` unless the caller asks for
``"cpu"``).  Without a process group the production mesh's 256 (or
512) shards all live in one process, so a run on it computes what the
sharded reference computes, expert parallelism included, with the
exchanges as index moves.  With one (``group=``, from
:func:`repro_torch.parallel.dist.init`) the ``model`` axis is split
over the group's ranks in blocks, each rank on its own ``device``, and
the expert exchanges run between the ranks (the model ranks are
tensor parallel too: ``parallel.sharding.make_ctx``);
``ranks`` (``{"data": a, "model": b}``, data-major, ``a * b`` the
world) splits the data axis over ranks too.
"""

from __future__ import annotations

import numpy as np

from ..core.rounds.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         group=None, ranks=None) -> Mesh:
    """(data 16, model 16), or (pod 2, data 16, model 16); ``group``
    splits the model axis over its ranks, or the axes of ``ranks``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)), device, group=group, ranks=ranks)


def make_local_mesh(device=None, group=None, ranks=None) -> Mesh:
    """One shard with the production axis names: every run takes the
    production code path, and gives what the port gives with no mesh
    (``group``, world 1 only, exercises the ranked path)."""
    return Mesh({"data": 1, "model": 1}, device, group=group, ranks=ranks)


def rank_layout(world: int, data_ranks: int = 1):
    """``ranks=`` for ``data_ranks`` data ranks and the rest of the
    ``world`` along the model axis (data-major); None, the default layout
    (the model axis over every rank), for one data rank."""
    if data_ranks < 1 or world % data_ranks:
        raise ValueError(f"{data_ranks} data ranks do not split a world "
                         f"of {world}")
    if data_ranks == 1:
        return None
    return {"data": data_ranks, "model": world // data_ranks}


def make_mesh_from_devices(devices, *, data: int, model: int,
                           pod: int | None = None, device=None) -> Mesh:
    """The elastic variant: a mesh over the first data x model (x pod)
    of ``devices``, a list of shard ids (the survivors after excluding
    failed hosts), laid out in the mesh's shape."""
    n = data * model * (pod or 1)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n])
    if pod:
        return Mesh({"pod": pod, "data": data, "model": model}, device,
                    devices=arr)
    return Mesh({"data": data, "model": model}, device, devices=arr)
