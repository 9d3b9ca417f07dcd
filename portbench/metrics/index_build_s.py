"""Mean seconds of the set-up's index builds (descriptors, database, calibration, map covariances); moves setup_s."""


def read(record):
    return record.get("index_build_s")
