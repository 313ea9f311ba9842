"""Entry-point applications — the rebuild of the reference's binaries
(SURVEY.md §2.5): render server (server.cpp), viewer client (client.cpp),
standalone renderer (rtracer.cpp). The MPI node layer maps to the local
device mesh (snail.parallel), so 'server' here owns all local devices
the way rank 0 + N node ranks owned cluster machines."""
