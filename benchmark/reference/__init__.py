"""The plain reference the benchmark holds the program's frames to. It
imports neither the program nor the JAX package, and takes only inputs the
benchmark makes."""
