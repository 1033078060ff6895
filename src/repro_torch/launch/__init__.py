"""Launch layer: node-stacked params, the consensus model, the prefill
step and the LM homogenization round (``launch/steps.py``,
``launch/train.py`` of the reference), and the sharded driver's ranks,
meshes and sharding rules (``launch/dist.py``, ``mesh.py``,
``sharding.py``)."""
