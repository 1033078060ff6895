"""Launch layer of the LM path: node-stacked params, the consensus model,
the prefill step and the LM homogenization round (``launch/steps.py``,
``launch/train.py`` of the reference)."""
