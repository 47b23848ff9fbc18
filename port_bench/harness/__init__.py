"""The benchmark's machinery: cells by name, inputs and weights from the
seed, the open-loop and training runners, the trace's reduction, and the
result line. It measures ``fast_neural_style_transfer_tpu_torch`` and
imports nothing of the JAX package."""
