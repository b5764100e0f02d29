"""Accelerator-resident shuffle (counterpart of the JAX package's
``shuffle/``; reference: RapidsShuffleManager + shuffle/ +
shuffle-plugin/), on one card:

  wire.py              self-describing columnar wire format (the JAX
                       package's frames, byte for byte)
  transport.py         transport SPI + bounce buffers; the in-process one
  socket_transport.py  the TCP loopback transport
  catalogs.py          shuffle/received buffer catalogs over memory/spill.py
  server.py            metadata + buffer-send state machine
  client.py            fetch state machine
  manager.py           caching writer/reader glue, transport selection

The JAX package's ``ici.py`` (the mesh all_to_all) needs more than one
card (ROADMAP A.9).
"""
