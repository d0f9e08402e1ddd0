"""As ``flash_roofline.decode``, over the prefill stretch's launches."""
from portbench.manifest import reader

read = reader("flash_roofline.decode")
