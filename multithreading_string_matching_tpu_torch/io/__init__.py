"""Host-side readers and decoders: pattern files, pcap captures, payload
extraction, synthetic corpora and the native ingest bridge."""
