"""The harness of the benchmark of portable_multigrid_tpu_torch: how a
cell's files are found (``spec``), its traffic (``traffic``), the run
(``session``), the reading of the profiler's trace (``trace``), the
roofline's yardstick (``counts``) and the check that decides ``correct``
(``check``)."""
