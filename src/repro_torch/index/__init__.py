"""Index structures on SiM pages (paper §V): B+Tree, extendible hash,
secondary index, and the CPU-centric baseline."""
