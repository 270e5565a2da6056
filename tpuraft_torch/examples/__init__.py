"""Entry points of the port: ``python -m tpuraft_torch.examples.rheakv_server``
serves one RheaKV store over TCP (``--engine`` drives its regions from
one MultiRaftEngine on the CUDA card)."""
