"""Reporting helpers of the port — counterpart of :mod:`repro.tools`."""
