"""The example CLIs of the PyTorch port, one module a Tengine example app
(python -m tengine_tpu_torch.examples.<name>). Each takes its JAX
counterpart's flags plus --device, runs on the card unless --device names
another, prints the same lines, and returns what it printed as data from
main(argv)."""
