"""Expert parallelism over ``torch.distributed``: the mesh's validation
(``constraints``), the placement rules (``sharding``) and the two-hop
all-to-all MoE dispatch (``collectives``)."""
