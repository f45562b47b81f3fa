"""The LM of the port, every block kind of the JAX model's: configuration,
layers, attention (GQA, MLA), MoE, SSM, RG-LRU, the model, and the map
from the JAX package's parameter and cache trees."""
