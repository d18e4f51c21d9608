"""The benchmark of armnet_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards: `python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout runs one cell of
BENCHMARK.json once (run.py). Nothing here imports JAX or the JAX package;
the plain reference (reference/) imports nothing of the port either."""
