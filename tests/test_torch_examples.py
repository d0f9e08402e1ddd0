"""The twins of the examples (``examples_torch/``) against the examples
themselves (``examples/``): each pair runs at once, each in a subprocess,
on the CPU, and their standard outputs are equal line for line, except
what each named mask hides (a wall-clock reading or a temporary path).
These eight twins reach no device: they run without ``--device`` (on a
host without a card a twin that did would raise).  The longer pairs have
files of their own (``test_torch_examples_prove.py``,
``test_torch_examples_pareto.py``), the runtime twins too
(``test_torch_examples_runtime.py``)."""
from pathlib import Path

import pytest

from torch_port_helpers import assert_same_output, run_example_pair

ROOT = Path(__file__).resolve().parents[1]
# {example: the fixed path it writes}: the pair runs a copy of the example
# that writes under tmp_path instead, so that no two runs share the path
FIXED_PATHS = {"quickstart": "/tmp/stage_demo_traces"}
# {twin: {what is hidden: (regex, replacement)}}
MASKS = {
    "quickstart": {
        # the JAX example's copy writes under tmp_path, the twin the same
        # name under the temporary directory TMPDIR names
        "the Chakra export's directory": (
            r"(rank traces to ).*stage_demo_traces$", r"\1<tmp>"),
    },
    "dse_sweep": {},
    "pipeline_schedules": {},
    "profile_and_timeline": {
        # the generator's self-profile: milliseconds each span took
        "the self-profile's total_ms and self_ms": (
            r"^(\S+\s+\d+)\s+\d+\.\d+\s+\d+\.\d+$", r"\1 <ms> <ms>"),
    },
    "resilience": {},
    "serve_generation": {},
    "topology_placement": {},
    "verify_trace": {
        # tempfile.mkdtemp(prefix="stage_trace_")
        "the export's temporary directory": (
            r"(/\S*)?stage_trace_\w+", "<tmp>"),
    },
}


@pytest.mark.parametrize("name", list(MASKS))
def test_twin_prints_what_the_example_prints(name, tmp_path):
    script = None
    if name in FIXED_PATHS:
        text = (ROOT / "examples" / f"{name}.py").read_text()
        assert FIXED_PATHS[name] in text
        script = tmp_path / f"{name}.py"
        script.write_text(text.replace(
            FIXED_PATHS[name], str(tmp_path / "jax" / Path(
                FIXED_PATHS[name]).name)))
    jax_lines, torch_lines = run_example_pair(name, tmp_path,
                                              jax_script=script)
    assert_same_output(name, jax_lines, torch_lines, MASKS[name])


def test_every_example_has_a_twin():
    """The twelve examples and their twins, by file name."""
    names = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert len(names) == 12
    assert sorted(p.name for p in (ROOT / "examples_torch").glob("*.py")) \
        == names
