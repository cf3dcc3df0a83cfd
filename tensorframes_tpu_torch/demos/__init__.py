"""The portable demos of the JAX package's ``demos/``, in PyTorch.

``kmeans`` (variants A to D), ``geom_mean``, ``groupby_scratch``,
``analytics`` (CSV -> filter -> mesh aggregate on composite device keys ->
rank) and ``train_lm`` (one device or a data x model mesh) keep their
functions' names, arguments and seeds. Variant E of k-means waits for the
native execution core (``ROADMAP.md`` A item 8).
"""
