"""``DeviceIndex.from_host`` to a synchronize: the occ rows, the text, the
suffix array and K1's j-mer table on the card."""


def read(rec):
    return rec["spans"]["index.upload_s"]
