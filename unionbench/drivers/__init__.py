"""One module per traffic kind, named by a mix's ``driver``."""
