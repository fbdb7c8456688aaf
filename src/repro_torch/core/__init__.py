"""SCOPE core of the port: fingerprints, retrieval, serialization, the
reasoning estimator, utility, calibration, alpha search, router container."""
