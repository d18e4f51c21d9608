"""The plain reference: each model configuration's forward in plain
float32 PyTorch (a module per model, `portbench.reference.<model>`, found
by the configuration's `model` key) and the pieces they share
(`common`): embedding, entmax by bisection, masked BatchNorm, MLP, BCE,
clamp, Adam and ROC-AUC. Imports neither JAX nor the measured program."""
