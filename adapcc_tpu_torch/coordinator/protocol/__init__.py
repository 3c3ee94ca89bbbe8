"""Generated protobuf messages for the coordinator protocol.

``coordinator_pb2.py`` is a copy of the JAX package's, generated from
``coordinator.proto``; regenerate with ``protoc --python_out=.
coordinator.proto`` in this directory.  Its serialized descriptor, file name
included, must stay byte-identical to the JAX package's: protobuf's default
pool takes a second registration of an identical file and refuses one that
differs.
"""
