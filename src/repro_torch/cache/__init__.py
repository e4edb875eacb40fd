"""OS page-cache model of the port (host side, numpy)."""
