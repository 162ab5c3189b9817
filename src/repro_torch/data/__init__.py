"""Data of the port (numpy copies of ``repro.data``): the synthetic tables
of the package-query benchmarks (``synth_tables``), the deterministic
sharded token pipeline of the trainer (``pipeline``) and the trainer's
package-query data selection (``selection``)."""
