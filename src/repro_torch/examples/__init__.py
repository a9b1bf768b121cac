# The port's runnable examples (analogues of the reference's examples/),
# kept inside the package: python -m repro_torch.examples.<name>.
