"""The benchmark of the PyTorch / CUDA port ``mrla_tpu_torch``.

One cell once: ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  The cells, the
metrics and their bounds are in ``BENCHMARK.json``; every configuration,
traffic mix, per-layer metric and correctness limit is a file of its own
under this folder, found by its name (``core/spec.py``).
"""
