"""Plain PyTorch references of the benchmark's configurations, float32.

They import nothing of the measured program, of ``jax`` or of the JAX
package: each is written from the published architecture, and takes only
what the benchmark itself made (weights, images, files). One module per
architecture, found by the ``arch`` of a configuration file."""
