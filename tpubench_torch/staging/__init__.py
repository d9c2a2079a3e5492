"""Storage→GPU staging: the slot rings (:mod:`.device`), the landing-kernel
ring (:mod:`.land_stage`), the overlapped transfer window
(:mod:`.executor`) and the stats they report (:mod:`.stats`).

Deliberately empty of imports, so that :mod:`.stats` loads without a
device runtime."""
