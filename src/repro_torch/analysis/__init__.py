"""Cost accounting (counterpart of ``repro/analysis``): model FLOPs and the
one-card roofline of a step (``roofline``)."""
