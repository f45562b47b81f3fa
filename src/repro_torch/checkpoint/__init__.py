"""Checkpoints of the parameters and optimizer state on disk, in the JAX
package's layout (``store``)."""
