"""Workloads of the port: the root read benchmark (:mod:`.read`)."""
