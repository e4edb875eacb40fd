"""Distribution: logical-axis sharding onto a ``DeviceMesh`` and the int8
error-feedback gradient compression across pods."""
