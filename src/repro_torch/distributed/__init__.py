"""Distribution: the sharding rules and their placement over a device mesh
(``torch.distributed``'s DTensor), and the collectives that compute the
model on the placed params (``collectives``)."""
