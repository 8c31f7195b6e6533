"""The inputs of each program, made from the seed: one module a program
(stencil_bench/programs/<name>.py imports its own)."""
