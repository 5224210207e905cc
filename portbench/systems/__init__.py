"""The system under test, one module a configuration ``family``: its
``serving`` function (the port's entry on the benchmark's weights), its
``control`` (the lower-precision control, which ``calibrate.py`` puts in
``serving``'s place), its ``ENTRY`` (the port's function a request calls,
which the fault tests break), its ``flops_per_image`` (``work/flops.py``)
and its ``reference`` module.  Training goes through the port's trainer,
which every family shares (``loops/train_steps.py``)."""
