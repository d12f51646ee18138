"""Multi-device placement: the sharding rules (:mod:`.sharding`) and the
collectives the serving mesh runs (:mod:`.comm`)."""
