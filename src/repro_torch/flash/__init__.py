"""The flash model of the port, host side (numpy): hardware parameters, the
analytic SSD simulator and the burst timeline that couples functional
backends to it."""
