"""What the examples share: the ``--cpu`` flag and a process group of
one."""

from __future__ import annotations

import argparse
import contextlib
import socket

import torch.distributed as dist

from ..ops.cuda_kernel import require_cuda


def parse_device(description: str, argv=None) -> str:
    """'cuda', or 'cpu' when ``--cpu`` is given."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the card")
    return "cpu" if parser.parse_args(argv).cpu else "cuda"


@contextlib.contextmanager
def process_group(device: str):
    """The default process group: the existing one (``torchrun``), or a
    group of this one process on a free local port (NCCL on the card,
    gloo on the host), destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    if device == "cuda":
        require_cuda()  # CudaUnavailableError, not NCCL's own complaint
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
