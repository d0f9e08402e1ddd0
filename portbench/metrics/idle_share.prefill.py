"""As ``idle_share.decode``, over the prefill stretch."""
from portbench.manifest import reader

read = reader("idle_share.decode")
