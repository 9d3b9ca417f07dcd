"""File formats: scans, labels, poses, graph JSON and the reference YAML."""
