"""The portable demos of the JAX package's ``demos/``, in PyTorch.

``kmeans`` (variants A and B), ``geom_mean`` and ``groupby_scratch`` keep
their functions' names, arguments and seeds. Variants C and D of k-means
(``distribute``, ``daggregate``) wait for the parallel layer and variant
E (the native core) for the native execution core (``ROADMAP.md`` A
items 7 and 8); ``analytics.py`` and ``train_lm.py`` wait for the same
layers.
"""
