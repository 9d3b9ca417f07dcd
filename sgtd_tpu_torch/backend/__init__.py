"""Back end: pose-graph optimization and Schur bundle adjustment (port of
``sgtd_tpu.backend``), with the conjugate-gradient solve they share."""
