"""Envelope encryption wrapper (a copy of juicefs_tpu/object/encrypt.py;
reference: pkg/object/encrypt.go:136-216).

Scheme (same shape as the reference):
  per-object random 256-bit data key + nonce
  body  = AES-256-GCM(data_key, nonce, plaintext)
  object = len(wrapped_key) || wrapped_key || nonce || body
  wrapped_key = RSA-OAEP(public_key, data_key)

The RSA key pair is the volume's master key (PEM, optionally password
protected — reference encrypt.go:66-123 ParseRsaPrivateKeyFromPem).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # gated: encrypted volumes error lazily, everything
    # else (the whole object package imports this module) keeps working
    HAVE_CRYPTOGRAPHY = False
    hashes = serialization = padding = rsa = AESGCM = None

from .interface import Obj, ObjectStorage


def _require_cryptography() -> None:
    if not HAVE_CRYPTOGRAPHY:
        raise RuntimeError(
            "the 'cryptography' package is not installed; encrypted "
            "volumes are unavailable in this environment"
        )


def generate_rsa_key_pem(bits: int = 2048, password: bytes | None = None) -> bytes:
    _require_cryptography()
    key = rsa.generate_private_key(public_exponent=65537, key_size=bits)
    enc = (
        serialization.BestAvailableEncryption(password)
        if password
        else serialization.NoEncryption()
    )
    return key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8, enc
    )


class RSAEncryptor:
    """Key encryptor: wraps per-object data keys (reference encrypt.go:125-145)."""

    def __init__(self, pem: bytes, password: bytes | None = None,
                 key=None):
        _require_cryptography()
        self._key = key if key is not None else \
            serialization.load_pem_private_key(pem, password)
        self._pad = padding.OAEP(
            mgf=padding.MGF1(algorithm=hashes.SHA256()),
            algorithm=hashes.SHA256(),
            label=None,
        )

    def encrypt(self, data_key: bytes) -> bytes:
        return self._key.public_key().encrypt(data_key, self._pad)

    def decrypt(self, wrapped: bytes) -> bytes:
        return self._key.decrypt(wrapped, self._pad)

    @property
    def wrapped_len(self) -> int:
        return self._key.key_size // 8


class AESGCMDataEncryptor:
    """Per-object AES-256-GCM (reference encrypt.go:147-216 dataEncryptor)."""

    NONCE = 12

    def __init__(self, key_encryptor: RSAEncryptor):
        self._ke = key_encryptor

    def encrypt(self, plaintext: bytes) -> bytes:
        dk = os.urandom(32)
        nonce = os.urandom(self.NONCE)
        body = AESGCM(dk).encrypt(nonce, plaintext, None)
        wrapped = self._ke.encrypt(dk)
        return struct.pack(">I", len(wrapped)) + wrapped + nonce + body

    def decrypt(self, blob: bytes) -> bytes:
        (klen,) = struct.unpack_from(">I", blob)
        wrapped = blob[4 : 4 + klen]
        nonce = blob[4 + klen : 4 + klen + self.NONCE]
        body = blob[4 + klen + self.NONCE :]
        dk = self._ke.decrypt(wrapped)
        return AESGCM(dk).decrypt(nonce, body, None)

    @property
    def overhead(self) -> int:
        # length header + wrapped key + nonce + GCM tag: fixed per volume key
        return 4 + self._ke.wrapped_len + self.NONCE + 16


class _Encrypted(ObjectStorage):
    def __init__(self, store: ObjectStorage, enc: AESGCMDataEncryptor):
        self._s = store
        self._e = enc

    def string(self) -> str:
        return self._s.string()

    def create(self) -> None:
        self._s.create()

    def put(self, key, data):
        self._s.put(key, self._e.encrypt(data))

    def get(self, key, off=0, limit=-1):
        # ciphertext is not seekable: fetch whole object, slice after decrypt
        # (reference encrypt.go Get does the same)
        data = self._e.decrypt(self._s.get(key))
        if limit < 0:
            return data[off:]
        return data[off : off + limit]

    def delete(self, key):
        self._s.delete(key)

    def head(self, key) -> Obj:
        o = self._s.head(key)
        return Obj(key=o.key, size=max(o.size - self._e.overhead, 0), mtime=o.mtime, is_dir=o.is_dir)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        for o in self._s.list_all(prefix, marker):
            yield Obj(key=o.key, size=max(o.size - self._e.overhead, 0), mtime=o.mtime, is_dir=o.is_dir)


class ECIESEncryptor:
    """EC key encryptor — an EXTENSION of this build, not reference parity
    (reference encrypt.go wraps keys with RSA-OAEP only; it has no ECIES):
    ephemeral-ECDH over P-256 + HKDF-SHA256 derives a wrapping key, the
    data key travels AES-GCM-sealed beside the ephemeral public key.

    wrapped = eph_pub(65B uncompressed) || nonce(12) || GCM(data_key)
    """

    _NONCE = 12

    def __init__(self, pem: bytes, password: bytes | None = None,
                 key=None):
        _require_cryptography()
        from cryptography.hazmat.primitives.asymmetric import ec

        self._key = key if key is not None else \
            serialization.load_pem_private_key(pem, password)
        if not isinstance(self._key, ec.EllipticCurvePrivateKey):
            raise ValueError("ECIES needs an EC private key (P-256 PEM)")
        self._curve = self._key.curve

    def _derive(self, shared: bytes) -> bytes:
        from cryptography.hazmat.primitives.kdf.hkdf import HKDF

        return HKDF(algorithm=hashes.SHA256(), length=32, salt=None,
                    info=b"jfs-ecies-v1").derive(shared)

    def encrypt(self, data_key: bytes) -> bytes:
        from cryptography.hazmat.primitives.asymmetric import ec

        eph = ec.generate_private_key(self._curve)
        shared = eph.exchange(ec.ECDH(), self._key.public_key())
        kek = self._derive(shared)
        nonce = os.urandom(self._NONCE)
        sealed = AESGCM(kek).encrypt(nonce, data_key, None)
        pub = eph.public_key().public_bytes(
            serialization.Encoding.X962,
            serialization.PublicFormat.UncompressedPoint,
        )
        return pub + nonce + sealed

    def decrypt(self, wrapped: bytes) -> bytes:
        from cryptography.hazmat.primitives.asymmetric import ec

        plen = (self._curve.key_size // 8) * 2 + 1  # uncompressed point
        pub = ec.EllipticCurvePublicKey.from_encoded_point(
            self._curve, wrapped[:plen]
        )
        shared = self._key.exchange(ec.ECDH(), pub)
        kek = self._derive(shared)
        nonce = wrapped[plen:plen + self._NONCE]
        sealed = wrapped[plen + self._NONCE:]
        return AESGCM(kek).decrypt(nonce, sealed, None)

    @property
    def wrapped_len(self) -> int:
        # point + nonce + data_key(32) + GCM tag(16)
        return (self._curve.key_size // 8) * 2 + 1 + self._NONCE + 48


def generate_ec_key_pem(password: bytes | None = None) -> bytes:
    _require_cryptography()
    from cryptography.hazmat.primitives.asymmetric import ec

    key = ec.generate_private_key(ec.SECP256R1())
    enc = (
        serialization.BestAvailableEncryption(password)
        if password
        else serialization.NoEncryption()
    )
    return key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8, enc
    )


class AESCTRDataEncryptor(AESGCMDataEncryptor):
    """AES-256-CTR body variant — an EXTENSION of this build, not reference
    parity (reference encrypt.go offers AEAD bodies only: aes256gcm-rsa and
    chacha20-rsa; no CTR mode exists there). CTR has no per-object auth tag,
    so ciphertext is malleable; `new_encrypted` therefore refuses to build a
    bare-CTR stack and always interposes the CRC32C checksummed wrapper
    between the cipher and the store, so every full-object GET verifies the
    ciphertext before decrypt. That catches corruption and blind bit-flips;
    operators needing cryptographic tamper resistance must use the GCM
    default."""

    def encrypt(self, plaintext: bytes) -> bytes:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        dk = os.urandom(32)
        nonce = os.urandom(16)  # full CTR counter block
        enc = Cipher(algorithms.AES(dk), modes.CTR(nonce)).encryptor()
        body = enc.update(plaintext) + enc.finalize()
        wrapped = self._ke.encrypt(dk)
        return struct.pack(">I", len(wrapped)) + wrapped + nonce + body

    def decrypt(self, blob: bytes) -> bytes:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        (klen,) = struct.unpack_from(">I", blob)
        wrapped = blob[4:4 + klen]
        nonce = blob[4 + klen:4 + klen + 16]
        body = blob[4 + klen + 16:]
        dk = self._ke.decrypt(wrapped)
        dec = Cipher(algorithms.AES(dk), modes.CTR(nonce)).decryptor()
        return dec.update(body) + dec.finalize()

    @property
    def overhead(self) -> int:
        return 4 + self._ke.wrapped_len + 16  # header + key + counter block


def _key_encryptor(pem: bytes, password: bytes | None):
    """RSA or EC PEM -> the matching key encryptor (reference
    encrypt.go:66-123 parses both). One parse: the loaded key object is
    handed to the encryptor (an encrypted PEM's KDF is not cheap)."""
    _require_cryptography()
    key = serialization.load_pem_private_key(pem, password)
    from cryptography.hazmat.primitives.asymmetric import ec

    if isinstance(key, ec.EllipticCurvePrivateKey):
        return ECIESEncryptor(pem, password, key=key)
    return RSAEncryptor(pem, password, key=key)


def new_encrypted(store: ObjectStorage, pem: bytes,
                  password: bytes | None = None,
                  algo: str = "aes256gcm") -> ObjectStorage:
    """Envelope-encrypt a store. algo: aes256gcm (default, reference
    parity) | aes256ctr (extension; forcibly paired with the CRC32C
    checksummed wrapper — see AESCTRDataEncryptor). The key side
    (RSA-OAEP per the reference, or the ECIES extension) follows the
    PEM key type."""
    ke = _key_encryptor(pem, password)
    if algo.startswith("aes256ctr"):
        from .checksum import new_checksummed

        return _Encrypted(new_checksummed(store), AESCTRDataEncryptor(ke))
    return _Encrypted(store, AESGCMDataEncryptor(ke))
