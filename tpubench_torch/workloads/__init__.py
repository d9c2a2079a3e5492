"""Workloads of the port: the root read benchmark (:mod:`.read`, with
the native executor route in :mod:`.fetch_executor`), pod-scale ingest
(:mod:`.pod_ingest`), the collective sweep (:mod:`.gather_bench`), the
transfer probe (:mod:`.probe`) and checkpoint save and restore
(:mod:`.ckpt`), among others."""
