"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level names compared whole: ``repro_torch`` is not ``repro``), the
reference and each module of layer kinds import nothing of the program,
and without a card the harness exits non-zero and prints no result."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                               "PATH": "/usr/bin:/bin"})


def test_a_run_loads_no_jax_module():
    r = _python(
        "import json, time, torch\n"
        "from portbench import core, manifest\n"
        "from portbench.tests.helpers import run\n"
        "b = manifest.Bench(manifest.HERE.parent)\n"
        "[b.reader(m['name']) for m in b.data['per_layer']]\n"
        "line, _ = run('jamba52b.decode-chat8')\n"
        "import sys\n"
        "print(json.dumps([core.forbidden_modules(), line['correct'], "
        "sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'})]))")
    assert r.returncode == 0, r.stderr[-2000:]
    forbidden, correct, tops = json.loads(r.stdout.strip().splitlines()[-1])
    assert forbidden == [] and correct and tops == ["repro_torch"]


@pytest.mark.parametrize("module", ["portbench.reference.model",
                                    "portbench.reference.deepseek_v2"])
def test_the_reference_imports_nothing_of_the_program(module):
    r = _python(f"import sys, {module}\n"
                "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert r.returncode == 0, r.stderr[-2000:]
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not tops & {"repro", "repro_torch", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import core
    monkeypatch.setitem(sys.modules, "repro_torchx", sys)
    assert "repro" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert core.forbidden_modules() == ["repro"]


def test_without_a_card_the_run_fails_and_prints_nothing(tmp_path):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "jamba52b.decode-chat8", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
