"""Parallelism: the (dp, fsdp, sp) mesh and FSDP2 (``mesh``), Ulysses
sequence parallelism (``sp``) and the VAE's temporal context parallelism
(``cp``)."""
