"""Multi-device placement: the sharding rules (:mod:`.sharding`) and the
collectives the serving and training meshes run (:mod:`.comm`)."""
