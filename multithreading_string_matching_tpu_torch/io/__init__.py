"""Host-side readers and decoders: pattern files, pcap captures, payload
extraction, flow reassembly, synthetic corpora and the native ingest
bridge."""
