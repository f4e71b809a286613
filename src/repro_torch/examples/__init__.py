"""The paper's demos on the port: one module per script of the JAX
package's ``examples/``, under the same name.

- ``quickstart``: a mixed SQL/NL session through the middleware;
- ``dashboard_session``: a Zipf dashboard stream through ``CacheService``;
- ``streaming_append``: a live dashboard refreshed from delta scans;
- ``multi_pod_dryrun``: a cold dashboard burst on the partitioned scan plane;
- ``train_canonicalizer``: train the canonicalizer LM, then serve it.

Each runs as ``python -m repro_torch.examples.<name>`` on the card
(``--device cuda``, the default; it raises where CUDA is absent) or, with
``--device cpu``, on the plain PyTorch path, and prints its JAX
counterpart's lines in the same order.  ``main(argv)`` returns a dict of
the numbers it printed, wall times left out.
"""
