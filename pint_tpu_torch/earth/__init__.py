from .erfa_lite import gcrs_posvel_from_itrf, itrf_to_gcrs_matrix  # noqa: F401
