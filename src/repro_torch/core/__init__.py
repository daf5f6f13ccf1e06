"""Integer codec core: bit helpers and the linear takum codec."""
