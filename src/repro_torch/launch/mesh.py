"""Device meshes and the card's rates.

``make_production_mesh()`` is a function: importing this module touches no
process group and no device. It lays the reference's production shapes
over the default process group the caller has set up
(``torch.distributed.init_process_group``): single pod (data=16,
model=16) = 256 ranks, multi-pod (pod=2, data=16, model=16) = 512 ranks,
one card per rank. The ``pod`` axis carries only data-parallel gradient
reduction; ``model`` stays inside the fastest links.

On H100 hosts of 8 cards, a 16-wide ``model`` axis spans two hosts, so
half of its traffic leaves the NVLink domain. ``LINK_BW`` is the NVLink
rate of one card and does not model the network between hosts, as the
reference's single ICI figure does not model its DCI links; the roofline's
collective term inherits that.

A dry run lays the mesh over the ``"fake"`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``) on the host,
one process standing for every rank, and allocates nothing.

The rates are the H100 SXM's data-sheet figures (NVIDIA, dense, no
sparsity), as the `hopper-kernels` guide tabulates them.
"""

from __future__ import annotations

#: Dense bf16 tensor-core peak of one H100 SXM, FLOP/s.
PEAK_BF16_FLOPS = 989e12
#: Dense int8 tensor-core peak of one H100 SXM, OP/s.
PEAK_INT8_OPS = 1979e12
#: Device-memory (HBM3) rate of one H100 SXM, bytes/s.
HBM_BW = 3.35e12
#: NVLink rate of one H100 SXM, each way, bytes/s.
LINK_BW = 450e9
#: Device memory of one H100 SXM, bytes.
HBM_BYTES = 80e9

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _group_size() -> int:
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call torch.distributed."
            "init_process_group (e.g. init_method='tcp://localhost:<port>' "
            "with world_size and rank, or backend='fake' for a dry run) "
            "before building a mesh")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group, whose
    world size must be 256 (512 with ``multi_pod``). ``device_type`` is
    the ranks' device; a dry run on the fake backend passes ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    want = 1
    for s in shape:
        want *= s
    got = _group_size()
    if got != want:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod mesh "
                         f"{dict(zip(axes, shape))} needs {want} ranks, the "
                         f"process group has {got}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, device_type: str = "cuda"):
    """A (data=1, model=n) mesh over the default process group: one rank
    per visible CUDA device, n = the group's world size, which must equal
    the card count. ``device_type="cpu"`` lays it over host ranks (tests
    on the ``gloo`` backend)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device (pass "
                           "device_type='cpu' for host ranks)")
    n = _group_size()
    if device_type == "cuda" and n != torch.cuda.device_count():
        raise ValueError(f"the host mesh takes one rank per card: "
                         f"{torch.cuda.device_count()} cards, {n} ranks")
    return init_device_mesh(device_type, (1, n),
                            mesh_dim_names=("data", "model"))
