"""The benchmark's yardstick: the SSB generator and the traffic it is
driven by, the plain reference and the comparison that decides
``correct``, the reduction of the profiler's trace, and the harness that
runs one cell of ``BENCHMARK.json`` against ``repro_torch``.  Nothing here
imports JAX or the JAX package; only ``harness`` (and ``ssbgen``'s
``port_*`` functions) touch the port."""
