"""Multi-device layout of the port (counterpart of ``repro.distributed``):
the logical-axis sharding rules (:mod:`.sharding`) and the ambient
context whose ``constrain`` hints place activations inside the model
(:mod:`.context`), both over ``torch.distributed.tensor`` (DTensor)."""
