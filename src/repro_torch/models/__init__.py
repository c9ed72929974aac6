"""The dense decoder LM: attention, FFN, blocks and the LM assembly."""
