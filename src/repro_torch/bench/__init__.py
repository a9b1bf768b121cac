# The paper's benchmark harnesses on the port (port of the reference's
# benchmarks/ package, which the static-analysis gate owns, so the port's
# copies live inside repro_torch).
