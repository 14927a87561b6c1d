"""The reference's networks, one module per preset name of the program
(``<generator>.py``, ``<discriminator>.py``, ``vgg19.py``), found by the
names a configuration gives. Each has ``build(config, dropout_dtype)``,
returning the network on the meta device with state-dict names equal to
the program's. A configuration whose preset has no module here cannot be
checked, and its run stops before any work."""
