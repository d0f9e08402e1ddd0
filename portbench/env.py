"""The process environment of a benchmark run, set before torch loads:
build and kernel caches at fixed places inside the checkout, one intra-op
thread (the host's work is the launches of one Python thread, and idle
intra-op threads only take cores from it), and the port's sources on the
path."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def prepare() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
