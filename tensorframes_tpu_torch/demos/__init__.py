"""The portable demos of the JAX package's ``demos/``, in PyTorch.

``kmeans`` (variants A and B), ``geom_mean``, ``groupby_scratch`` and
``train_lm`` (single device) keep their functions' names, arguments and
seeds. Variants C and D of k-means (``distribute``, ``daggregate``) wait
for the parallel layer and variant E (the native core) for the native
execution core (``ROADMAP.md`` A items 7 and 8); ``analytics.py`` waits
for the same layers, and ``train_lm``'s mesh for the parallel layer.
"""
