"""The plain reference of the benchmark: plain PyTorch and numpy, computed in
float32 with TF32 off by whoever calls it. It imports no JAX and nothing of
the program under test, and takes nothing the program made: the benchmark
hands it the same inputs and weights it hands the program."""
