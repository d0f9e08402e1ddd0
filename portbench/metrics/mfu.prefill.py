"""As ``mfu.decode``, over the window's prompt tokens."""
from portbench.manifest import reader

read = reader("mfu.decode")
