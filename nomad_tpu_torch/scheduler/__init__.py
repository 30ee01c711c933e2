"""Scheduler layer: dense scheduling over the port's kernels + host-side
reconciler.

Reference: scheduler/ in hollowsunsets/nomad.  The lazy pull-based
RankIterator pipeline is replaced by batched dense kernels in
`nomad_tpu_torch.ops`; this package holds the schedulers that drive them,
the reconciler, the factory registry, and the test harness.
"""
