"""Multi-device localization and bundle adjustment on ``torch.distributed``
(port of ``sgtd_tpu.parallel``): one process a rank, a ``DeviceMesh`` of
named dims, and the collectives of ``parallel.mesh``."""
