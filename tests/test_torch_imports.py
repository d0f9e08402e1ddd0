"""The port stands alone: it imports torch, never jax and nothing of the JAX
package; its kernel sources are in the tree and its build lands in an ignored
directory; on a CPU tensor the wrapper is the plain version."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# ml_dtypes comes with jax: an install of torch alone has none
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_files():
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_and_no_compile(path):
    """The yardstick call lives in chip_smoke.py only."""
    text = path.read_text()
    assert "torch.compile" not in text
    if path.name != "chip_smoke.py":
        assert "scaled_dot_product_attention" not in text


def test_import_leaves_jax_out_of_the_process():
    code = ("import sys; import repro_torch, repro_torch.launch.serve, "
            "repro_torch.kernels, repro_torch.serve, repro_torch.configs, "
            "repro_torch.core.dse, repro_torch.core.batched, "
            "repro_torch.obs, repro_torch.obs.__main__, "
            "repro_torch.analysis, repro_torch.analysis.__main__, "
            "repro_torch.train, repro_torch.data, repro_torch.ckpt, "
            "repro_torch.launch.train; "
            "repro_torch.configs.all_archs(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                       "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_kernel_sources_and_build_dir():
    from repro_torch.kernels import _build
    cu = sorted(p.name for p in (PKG / "kernels" / "csrc").glob("*.cu"))
    assert cu == ["cost_reduce.cu", "flash_attention.cu", "rwkv6_scan.cu"]
    assert _build.sources() == ["cost_reduce", "flash_attention",
                                "rwkv6_scan"]
    for name in cu:
        text = (PKG / "kernels" / "csrc" / name).read_text()
        assert "__global__" in text and 'extern "C"' in text
        assert "torch/extension.h" not in text
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "src/repro_torch/kernels/_build/" in ignored
    assert _build.BUILD_DIR == PKG / "kernels" / "_build"
    assert _build.library_path("flash_attention").parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_missing_nvcc_raises_with_reason(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.find_nvcc()


def test_failed_compile_raises_with_compiler_output(monkeypatch, tmp_path):
    """A stand-in compiler that fails: its output must reach the caller."""
    from repro_torch.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such thing' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:/usr/bin:/bin")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelCompileError, match="no such thing"):
        _build.load("flash_attention")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_wrapper_on_cpu_is_the_plain_version():
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 2, 3, 16, generator=g)
    k = torch.randn(2, 9, 2, 16, generator=g)
    v = torch.randn(2, 9, 2, 16, generator=g)
    kw = dict(causal=True, window=4, softcap=10.0, q_offset=4)
    assert torch.equal(fa.flash_attention(q, k, v, **kw),
                       fa.flash_attention_plain(q, k, v, **kw))
    from repro_torch.kernels import rwkv6_scan as wkv
    r, k, v = (torch.randn(2, 8, 3, 16, generator=g) for _ in range(3))
    w = torch.rand(2, 8, 3, 16, generator=g)
    u, s0 = torch.randn(3, 16, generator=g), torch.randn(2, 3, 16, 16,
                                                         generator=g)
    got, want = wkv.wkv6(r, k, v, w, u, s0, chunk=4), \
        wkv.wkv6_plain(r, k, v, w, u, s0, chunk=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    from repro_torch.kernels import cost_reduce as cr
    x = torch.randn(5, 40, generator=g, dtype=torch.float64)
    w = torch.randint(0, 3, (3, 40), generator=g).double()
    assert torch.equal(cr.cost_reduce_bet(x, w), cr.cost_reduce_plain(x, w))


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: exit code other than 0 and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, cwd=str(ROOT))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
