"""The serving layer of the port: :class:`~.engine.ServingEngine` replicas in
a :class:`~.fleet.ReplicaFleet` behind the POTUS request dispatcher
(:class:`~.dispatcher.PotusDispatcher`), DESIGN.md §10."""
