"""The portable demos of the JAX package's ``demos/``, in PyTorch.

``kmeans`` (variants A to D), ``geom_mean``, ``groupby_scratch`` and
``train_lm`` (single device) keep their functions' names, arguments and
seeds. Variant E of k-means waits for the native execution core
(``ROADMAP.md`` A item 8); ``analytics.py`` and ``train_lm``'s mesh wait
for the rest of the parallel layer (A item 7b).
"""
