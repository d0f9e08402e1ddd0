"""``examples_torch/pareto_search.py --device cpu`` against
``examples/pareto_search.py`` (about 25 s each, run at once): the front,
the branch-and-bound's visits and the batched sweep's summary, line for
line, nothing hidden.  The twin's batched sweep takes ``--device``: on the
card its busy-group sums are ``cost_reduce`` launches (chip_smoke.py's
examples phase counts them)."""
from torch_port_helpers import assert_same_output, run_example_pair


def test_pareto_search_twin_prints_what_the_example_prints(tmp_path):
    jax_lines, torch_lines = run_example_pair(
        "pareto_search", tmp_path, twin_args=("--device", "cpu"))
    assert_same_output("pareto_search", jax_lines, torch_lines)
