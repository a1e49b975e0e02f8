"""Device selection.  The port never picks a device on its own: callers name
one, and asking for CUDA where there is none is an error, not a quiet move
to the CPU."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device, or a ``RuntimeError`` saying why there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch %s, built for CUDA %s); the "
            "port's fused chain runs its kernels on an NVIDIA GPU — pass an "
            "explicit CPU device to run the plain PyTorch versions instead"
            % (torch.__version__, torch.version.cuda))
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(name: str | torch.device) -> torch.device:
    """``'cuda'``/``'cuda:N'`` (which must exist) or ``'cpu'``."""
    dev = torch.device(name)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev
