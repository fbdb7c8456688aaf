"""Configs of the port: ``base.ModelConfig`` and the SCOPE estimator configs
(``scope_estimator.CONFIG`` / ``TINY``)."""
