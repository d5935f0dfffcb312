"""What the example CLIs of examples_torch/ share: the --device flag, the
device's clock, and the --mesh process group.

The CLIs are the PyTorch port's counterparts of examples/*.py (the JAX
package's): the same flags, defaults, data and printed lines, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels)."""

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def add_device_flag(ap):
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the sampler runs: 'cuda' (default; the "
                         "hand-written kernels) or 'cpu' (their plain "
                         "PyTorch versions)")


def device_of(name):
    """The torch device of --device; 'cuda' raises without a card (no
    fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: no CUDA device is available to this "
                "process; pass --device cpu for the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def sync(device):
    """Wait for the device's queued work (the timings read the host
    clock)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def mesh_context(enabled, device):
    """The 1-D particle mesh of --mesh (None without it): the group of the
    torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when
    it is set, else a one-process group; NCCL for a card, gloo for the
    CPU. A group this opens is closed on exit, after the samplers' graphs
    are freed (a graph that captured an NCCL collective holds its
    communicator, whose destruction waits for it)."""
    if not enabled:
        yield None
        return
    from stein_tpu_torch.parallel import particle_mesh, setup_distributed
    from stein_tpu_torch.utils import graphs

    created = not dist.is_initialized()
    if created:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            setup_distributed(backend)
        else:
            setup_distributed(
                backend, store=dist.HashStore(), world_size=1, rank=0,
                device_id=device if device.type == "cuda" else None)
    try:
        yield particle_mesh()
    finally:
        if created:
            graphs.release()
            dist.destroy_process_group()
