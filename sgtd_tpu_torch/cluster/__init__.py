"""Clustering of labeled point clouds (port of sgtd_tpu.cluster): DCVC and FEC."""
