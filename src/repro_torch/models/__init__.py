"""The dense decoder LM of the port: configuration, layers, attention,
model, and the map from the JAX package's parameter tree."""
