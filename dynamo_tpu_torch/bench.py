"""The port's bench: for now, the launch-overhead probe.

    python -m dynamo_tpu_torch.bench

prints one JSON line with the card's name and ``dispatch_overhead_ms``:
the wall milliseconds one kernel launch costs on its own, measured as the
JAX package's ``bench.py`` ``_pallas_dispatch_overhead_ms`` measures it for
a ``pallas_call``: a chain of ``n`` dependent launches of a no-op kernel
(``csrc/nop.cu``, one [8, 128] f32 copy) through the same ctypes wrapper
path the attention kernels use, synchronised, best of 3, divided by ``n``.
The per-piece attention path launches two kernels per layer in a mixed
step where the megakernel launches one, so this is the tax that separates
them when the kernels themselves are short.

``nop`` follows the port's wrapper rules: on a CUDA tensor it launches the
kernel or raises, on a CPU tensor it runs its plain version
(``x.clone()``). The probe itself has no CPU form: it measures the card.
"""

from __future__ import annotations

import ctypes
import json
import time

import torch

from dynamo_tpu_torch import _build

KERNEL_LAUNCHES = 0
REF_CALLS = 0


def nop_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the no-op kernel: a copy."""
    return x.clone()


def _kernel():
    fn = _build.load("nop").dtt_nop
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nop(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` (f32, contiguous) made by one launch of the no-op
    kernel on a CUDA tensor, or by ``nop_ref`` on a CPU tensor."""
    global KERNEL_LAUNCHES, REF_CALLS
    if x.device.type == "cpu":
        REF_CALLS += 1
        return nop_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"nop runs on cuda or cpu tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"nop copies contiguous float32 tensors, got {x.dtype}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nop kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES += 1
    return out


def dispatch_overhead_ms(n: int = 32) -> float:
    """Wall milliseconds per launch of ``n`` chained no-op launches on the
    current CUDA device (synchronised, best of 3). Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("dispatch_overhead_ms needs a CUDA device; torch.cuda.is_available() is false")
    dev = torch.device("cuda", torch.cuda.current_device())

    def chain(x):
        for _ in range(n):
            x = nop(x)
        return x

    x = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    chain(x)  # build, load and warm
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        chain(x)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best / n * 1000.0


def main() -> None:
    ms = dispatch_overhead_ms()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "dispatch_overhead_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
