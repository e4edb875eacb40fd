"""The flash model of the port, host half: hardware parameters and the
analytic SSD simulator (host side, numpy)."""
