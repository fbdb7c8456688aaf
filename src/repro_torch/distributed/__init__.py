"""Distribution: the sharding rules and their placement over a device mesh
(``torch.distributed``'s DTensor)."""
