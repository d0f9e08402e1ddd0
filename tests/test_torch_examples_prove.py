"""``examples_torch/prove_space.py`` against ``examples/prove_space.py``
(about 50 s each, run at once): the same certificate, classes and sweep
summary line for line; hidden are the three lines that read the clock
(the cold and warm proof's seconds, and the point-by-point estimate from
a timed slice)."""
from torch_port_helpers import assert_same_output, run_example_pair

MASKS = {
    "the cold proof's seconds": (r"^prove\[cold\]\s+\d+\.\d+s", "prove[cold] <s>"),
    "the warm proof's seconds": (r"^prove\[warm\]\s+\d+\.\d+s", "prove[warm] <s>"),
    "the timed slice's ms/config and its extrapolation": (
        r"^vs sweeping: ~\d+\.\d+ ms/config x (\d+) configs ≈ \d+ min",
        r"vs sweeping: <ms>/config x \1 configs ≈ <min>"),
}


def test_prove_space_twin_prints_what_the_example_prints(tmp_path):
    jax_lines, torch_lines = run_example_pair("prove_space", tmp_path)
    assert_same_output("prove_space", jax_lines, torch_lines, MASKS)
