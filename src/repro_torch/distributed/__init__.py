"""Distribution: the JAX package's sharding rules and elastic re-mesh over
``torch.distributed`` (``DeviceMesh``, DTensor)."""
