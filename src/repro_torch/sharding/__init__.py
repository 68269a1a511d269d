"""repro_torch.sharding — the partition rules (:mod:`.partition`, port of
``repro.sharding.partition``) and the collectives a mesh rank runs
(:mod:`.collectives`)."""
