"""NumPy/pure-Python oracle of the GDiet mapping pipeline.

This subpackage is the *ground truth* for the device implementation: each
module re-derives (not ports) the semantics of one reference stage and is
validated against the reference's prebuilt binary on synthetic data. The
device pipeline in gdiet_tpu.ops / gdiet_tpu.pipeline is tested for
equivalence against this oracle. The reference has no unit tests
(SURVEY.md §4); these oracles are how we manufacture ours.
"""
