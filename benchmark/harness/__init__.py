"""The benchmark's own machinery: cells and configurations read from their
files, the card check, the weights made from the seed, the traffic
generator, the windows' arithmetic, the trace reduction, the work counts
and the result line. Nothing here imports JAX or the JAX package."""
