"""Runtime glue for tensors: the tensor serializer (``serialization.py``)."""
