"""The plain reference of the cells' models: torch only, float32 with TF32
off, no kernel, no cache and no batching of the program.  It imports
nothing of the program; it reads the benchmark's own weight tree
(``portbench.weights``) and works everything else out again."""
