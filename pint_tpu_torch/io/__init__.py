"""File formats of the port (host numpy): ``fits.py``, the FITS
binary-table reader and writer the photon path uses."""
