"""Fleet builders, one module per configuration family: each gives a
pulsar's par text and its TOA schedule (UTC epochs, frequencies, flags,
site). A configuration's file names its builder; ``fleet.py`` finds it
by that name."""
